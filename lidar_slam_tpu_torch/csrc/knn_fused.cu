// Exact gated k-NN over a cell-sorted bucket grid, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/knn_fused.py::window_knn (body _kernel, call _knn_call)
// used by A-LOAM's correspondence search (pipeline/aloam/odometry.py and
// mapping.py). It computes what that kernel computes: for each valid query,
// among the table rows with d2 <= r2 (float32), the k smallest by
// (d2, sorted-row index), each returned as its feature row (x, y, z, valid,
// original index, extras) followed by d2. A rank with no neighbour returns
// zero features and d2 = +inf; an invalid query returns no neighbours.
//
// What was dropped: the TPU kernel brute-forces a fixed-width column window
// of the table per 128-query tile and extracts each rank with a one-hot MXU
// contraction, because Mosaic has no VMEM gather. Here each query walks its
// own 3x3x3 stencil through the grid's CSR arrays (cell_starts, cell_counts)
// and reads candidate rows directly. The stencil covers every in-gate
// neighbour when cell_size >= the gate radius (the wrapper enforces it), so
// nothing can fall outside a window: `unresolved` is 0 by construction.
// For a fixed (x, y) column the three z cells are consecutive flat ids, so
// their rows are one contiguous range of the sorted table: 9 ranges a query.
//
// d2 is the direct difference (dx*dx + dy*dy) + dz*dz, never the
// |q|^2 - 2 q.t expansion, written with __fmul_rn / __fadd_rn so nvcc cannot
// contract it into FMAs: the value then matches PyTorch's separate ops to
// the bit, and near-ties break the same way in kernel and plain version.
//
// Design: one warp serves one query. Each lane scans every 32nd row of each
// range (neighbouring lanes read neighbouring 32-byte rows) and keeps a
// sorted register list of K entries (K = 5 or 8, a template parameter,
// fully unrolled, no local memory). The warp then merges its 32 lists: K
// rounds of a butterfly argmin over (d2, row), the owning lane pops its
// head. Rows are unique, so the order is total and the result does not
// depend on which lane saw which row.
//
// What bounds it on an H100: latency of the dependent row reads, and too
// few queries to fill the card. Odometry's 5 m cells hold up to hundreds of
// points over only 1-2 k queries, so one thread per query would leave most
// SMs idle and serialise each long scan: that variant was measured 2-16x
// slower than the warp per query on every search of the A-LOAM operating
// point (PERF.md). Mapping has 8-16 k queries over 1 m cells of a few
// points; the table (<= 131 072 rows x 32 B = 4 MB) stays in the 50 MB L2.
//
// Build (plain C interface, loaded through ctypes; no torch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libknn_fused.so knn_fused.cu

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Per-call constants, passed by value (ctypes mirror in ops/cuda/knn_fused.py).
struct KnnParams {
  float cell_size;
  float r2;     // gate radius squared, float32
  int dims[3];  // grid dims, flat cell id = (x * dims[1] + y) * dims[2] + z
  int nq;       // number of queries
};

namespace {

constexpr int kThreads = 128;
constexpr int kFeat = 8;          // feature-table row: x y z valid idx extras[3]
constexpr int kOut = kFeat + 1;   // + d2
constexpr int kNone = INT_MAX;    // row of an empty list entry (sorts last)

__device__ __forceinline__ bool before(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// floor((q - o) / cs), clamped to the grid: the query's clipped cell
__device__ __forceinline__ int clipped_cell(float q, float o, float cs, int dim) {
  const float c = floorf(__fdiv_rn(__fsub_rn(q, o), cs));
  return static_cast<int>(fminf(fmaxf(c, 0.0f), static_cast<float>(dim - 1)));
}

template <int K>
__device__ __forceinline__ void insert(float d, int r, float (&bd)[K], int (&br)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (before(d, r, bd[j], br[j])) {
      const float td = bd[j];
      const int tr = br[j];
      bd[j] = d;
      br[j] = r;
      d = td;
      r = tr;
    }
  }
}

template <int K>
__device__ __forceinline__ void pop_head(float (&bd)[K], int (&br)[K]) {
#pragma unroll
  for (int j = 0; j + 1 < K; ++j) {
    bd[j] = bd[j + 1];
    br[j] = br[j + 1];
  }
  bd[K - 1] = CUDART_INF_F;
  br[K - 1] = kNone;
}

__device__ __forceinline__ void write_rank(float* __restrict__ o, const float4* __restrict__ table,
                                           float d, int r) {
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
  if (r != kNone) {
    a = __ldg(table + 2 * r);
    b = __ldg(table + 2 * r + 1);
  } else {
    d = CUDART_INF_F;
  }
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  o[8] = d;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float4* __restrict__ table, const int* __restrict__ starts,
               const int* __restrict__ counts, const float* __restrict__ origin,
               const float* __restrict__ queries, const uint8_t* __restrict__ qmask,
               const KnnParams p, float* __restrict__ out) {
  const int q = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= p.nq) return;  // the whole warp leaves together

  float bd[K];
  int br[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    br[j] = kNone;
  }

  const float qx = queries[3 * q], qy = queries[3 * q + 1], qz = queries[3 * q + 2];
  if (qmask[q] != 0 && isfinite(qx) && isfinite(qy) && isfinite(qz)) {
    const int d0 = p.dims[0], d1 = p.dims[1], d2 = p.dims[2];
    const int cx = clipped_cell(qx, origin[0], p.cell_size, d0);
    const int cy = clipped_cell(qy, origin[1], p.cell_size, d1);
    const int cz = clipped_cell(qz, origin[2], p.cell_size, d2);
    const int z0 = max(cz - 1, 0), z1 = min(cz + 1, d2 - 1);
    for (int nx = max(cx - 1, 0); nx <= min(cx + 1, d0 - 1); ++nx) {
      for (int ny = max(cy - 1, 0); ny <= min(cy + 1, d1 - 1); ++ny) {
        const int col = (nx * d1 + ny) * d2;
        const int lo = __ldg(starts + col + z0);
        const int hi = __ldg(starts + col + z1) + __ldg(counts + col + z1);
        for (int r = lo + lane; r < hi; r += 32) {
          const float4 t = __ldg(table + 2 * r);
          const float dx = __fsub_rn(t.x, qx), dy = __fsub_rn(t.y, qy), dz = __fsub_rn(t.z, qz);
          const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          if (dd <= p.r2 && before(dd, r, bd[K - 1], br[K - 1])) insert<K>(dd, r, bd, br);
        }
      }
    }
  }

  // merge the 32 lists; lane j keeps rank j
  float my_d = CUDART_INF_F;
  int my_r = kNone;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float d = bd[0];
    int r = br[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int orr = __shfl_xor_sync(0xffffffffu, r, off);
      if (before(od, orr, d, r)) {
        d = od;
        r = orr;
      }
    }
    if (lane == j) {
      my_d = d;
      my_r = r;
    }
    if (r != kNone && br[0] == r) pop_head<K>(bd, br);
  }
  if (lane < K) write_rank(out + (static_cast<size_t>(q) * K + lane) * kOut, table, my_d, my_r);
}

}  // namespace

extern "C" {

// Launches the k-NN on `stream`. `table` holds [N, 8] float32 rows (16-byte
// aligned), `out` [nq, k, 9] float32, k is 5 or 8. Returns
// cudaGetLastError() (0 = ok).
int knn_fused_launch(const float* table, const int* starts, const int* counts, const float* origin,
                     const float* queries, const uint8_t* qmask, const KnnParams* params, int k,
                     float* out, void* stream) {
  const KnnParams p = *params;
  if (p.nq <= 0) return 0;
  const int blocks = (p.nq + kThreads / 32 - 1) / (kThreads / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (k == 5) {
    knn_kernel<5><<<blocks, kThreads, 0, s>>>(t4, starts, counts, origin, queries, qmask, p, out);
  } else if (k == 8) {
    knn_kernel<8><<<blocks, kThreads, 0, s>>>(t4, starts, counts, origin, queries, qmask, p, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
