// Exact gated k-NN over a cell-sorted bucket grid, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/knn_fused.py::window_knn (body _kernel, call _knn_call)
// used by A-LOAM's correspondence search (pipeline/aloam/odometry.py and
// mapping.py). It computes what that kernel computes: for each valid query,
// among the grid's valid points with d2 <= r2 (float32), the k smallest by
// (d2, sorted-row index), each returned as its original index, distance,
// coordinates and extras. A rank with no neighbour returns index 0, zero
// coordinates and extras, distance +inf and ok = 0; an invalid query (masked
// or non-finite) returns no neighbours.
//
// What was dropped: the TPU kernel brute-forces a fixed-width column window
// of a packed feature table per 128-query tile and extracts each rank with a
// one-hot MXU contraction, because Mosaic has no VMEM gather. Here each
// query walks its own 3x3x3 stencil through the grid's CSR arrays
// (cell_starts, cell_counts) and reads candidate rows directly. The stencil
// covers every in-gate neighbour when cell_size >= the gate radius (the
// wrapper enforces it), so `unresolved` is 0 by construction. For a fixed
// (x, y) column the three z cells are consecutive flat ids, so their rows
// are one contiguous range of the sorted table: 9 ranges a query.
//
// One launch from the grid to the result: the kernel reads the grid's own
// arrays (points [N, 3] in sorted order, point_idx, cell_starts,
// cell_counts, origin) and, for the k winners only, their original index and
// the caller's extras ([N, E] in original order, int32 or float32, read
// through point_idx and converted to float32). It writes idx, dist, ok, pts,
// extras and unresolved itself: no feature table, no cast pass, no unpack.
//
// d2 is the direct difference (dx*dx + dy*dy) + dz*dz, never the
// |q|^2 - 2 q.t expansion, written with __fmul_rn / __fadd_rn so nvcc cannot
// contract it into FMAs: the value then matches PyTorch's separate ops to
// the bit, and near-ties break the same way in kernel and plain version.
// dist is the correctly rounded __fsqrt_rn, as torch.sqrt.
//
// Design: a group of G lanes (G = 16 or 32, a template parameter)
// serves one query. Each lane scans every G-th row of each range and keeps a
// sorted register list of K entries (K = 5 or 8, fully unrolled, no local
// memory). The group then merges its G lists: K rounds of a butterfly argmin
// over (d2, row) within the group, the owning lane pops its head. Rows are
// unique, so the order is total and the result does not depend on which
// lane saw which row, nor on the query order. The scan is latency-bound,
// so loads are issued ahead of their use: the 9 ranges' 27 CSR words
// together, then each lane's first row of all 9 columns together, then the
// rest of each column kUnroll rows at a time; after the merge every lane
// writes its ranks at once, so the K ranks' dependent index and extras
// loads overlap.
//
// Rows are read from global memory, not staged in shared memory for a run
// of same-cell queries: against this kernel's first version, staging gained
// at most 0.5 us over the best unstaged lane count on any search (PERF.md,
// K2's redesign); the rows a block's groups share already hit in L1.
//
// What bounds it on an H100: latency of the dependent row reads, and too
// few queries to fill the card, not bytes or FLOPs (the table, <= 131 072
// rows x 12 B, stays in the 50 MB L2). Mapping's 1 m cells hold a few
// points each and odometry's 5 m cells hundreds, so the lanes a query needs
// differ by the grid: the wrapper picks G from the cell size
// (ops/cuda/knn_fused.py::default_lanes; PERF.md gives the lane sweep
// behind it, and why 4 and 8 lanes are not compiled).
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
  float r2;        // gate radius squared, float32
  int dims[3];     // grid dims, flat cell id = (x * dims[1] + y) * dims[2] + z
  int nq;          // number of queries
  int n_extra;     // E: extra columns per target point (0 without extras)
  int extras_int;  // 1: the extras are int32, 0: float32
};

namespace {

constexpr int kThreads = 128;
constexpr int kNone = INT_MAX;  // row of an empty list entry (sorts last)
constexpr int kUnroll = 4;      // rows of a column a lane loads before it uses them

struct Grid {  // the bucket grid's arrays
  const float* points;    // [N, 3] sorted by cell
  const int* point_idx;   // [N] original index of each sorted row
  const int* starts;      // [V] first row of each cell
  const int* counts;      // [V] valid rows of each cell
  const float* origin;    // [3]
};

struct Out {  // the result tensors, [nq, K] (pts [nq, K, 3], extras [nq, K, E])
  int* idx;
  float* dist;
  uint8_t* ok;
  float* pts;
  float* extras;
};

__device__ __forceinline__ bool before(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// floor((q - o) / cs), clamped to the grid: the query's clipped cell
__device__ __forceinline__ int clipped_cell(float q, float o, float cs, int dim) {
  const float c = floorf(__fdiv_rn(__fsub_rn(q, o), cs));
  return static_cast<int>(fminf(fmaxf(c, 0.0f), static_cast<float>(dim - 1)));
}

// The 9 row ranges [lo, hi) of the stencil around cell (cx, cy, cz); a
// column outside the grid is empty. All 27 loads are independent.
__device__ __forceinline__ void stencil_ranges(const Grid& g, const KnnParams& p, int cx, int cy, int cz,
                                               int (&lo)[9], int (&hi)[9]) {
  const int d1 = p.dims[1], d2 = p.dims[2];
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, d2 - 1);
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int nx = cx + c / 3 - 1, ny = cy + c % 3 - 1;
    lo[c] = 0;
    hi[c] = 0;
    if (nx >= 0 && nx < p.dims[0] && ny >= 0 && ny < d1) {
      const int col = (nx * d1 + ny) * d2;
      lo[c] = __ldg(g.starts + col + z0);
      hi[c] = __ldg(g.starts + col + z1) + __ldg(g.counts + col + z1);
    }
  }
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

// d2 of row r at (tx, ty, tz) from the query; kept if in the gate and
// before the list's last entry
template <int K>
__device__ __forceinline__ void consider(float tx, float ty, float tz, int r, float qx, float qy, float qz,
                                         float r2, float (&bd)[K], int (&br)[K]) {
  const float dx = __fsub_rn(tx, qx), dy = __fsub_rn(ty, qy), dz = __fsub_rn(tz, qz);
  const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  if (dd <= r2 && before(dd, r, bd[K - 1], br[K - 1])) insert<K>(dd, r, bd, br);
}

// One result slot: row r (kNone = no neighbour) at d2 = d.
__device__ __forceinline__ void write_rank(const Grid& g, const void* extras, const KnnParams& p, const Out& o,
                                           size_t slot, float d, int r) {
  const bool found = r != kNone;
  int idx = 0;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (found) {
    idx = __ldg(g.point_idx + r);
    x = __ldg(g.points + 3 * static_cast<size_t>(r));
    y = __ldg(g.points + 3 * static_cast<size_t>(r) + 1);
    z = __ldg(g.points + 3 * static_cast<size_t>(r) + 2);
  }
  o.idx[slot] = idx;
  o.dist[slot] = found ? __fsqrt_rn(d) : CUDART_INF_F;
  o.ok[slot] = found ? 1 : 0;
  o.pts[3 * slot] = x;
  o.pts[3 * slot + 1] = y;
  o.pts[3 * slot + 2] = z;
  for (int e = 0; e < p.n_extra; ++e) {
    float v = 0.0f;
    if (found) {
      const size_t at = static_cast<size_t>(idx) * p.n_extra + e;
      v = p.extras_int ? __int2float_rn(__ldg(static_cast<const int*>(extras) + at))
                       : __ldg(static_cast<const float*>(extras) + at);
    }
    o.extras[slot * p.n_extra + e] = v;
  }
}

template <int K, int G>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const Grid g, const float* queries, const uint8_t* qmask, const void* extras, const KnnParams p,
               const Out o, float* unresolved) {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two, 2 to 32");
  const int gl = threadIdx.x & (G - 1);
  const int q = (blockIdx.x * kThreads + threadIdx.x) / G;
  if (blockIdx.x == 0 && threadIdx.x == 0) *unresolved = 0.0f;

  float bd[K];
  int br[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    br[j] = kNone;
  }

  // no thread returns early: every lane takes part in the merge's shuffles
  if (q < p.nq) {
    const float qx = __ldg(queries + 3 * q), qy = __ldg(queries + 3 * q + 1), qz = __ldg(queries + 3 * q + 2);
    if (qmask[q] != 0 && isfinite(qx) && isfinite(qy) && isfinite(qz)) {
      int lo[9], hi[9];
      stencil_ranges(g, p, clipped_cell(qx, __ldg(g.origin), p.cell_size, p.dims[0]),
                     clipped_cell(qy, __ldg(g.origin + 1), p.cell_size, p.dims[1]),
                     clipped_cell(qz, __ldg(g.origin + 2), p.cell_size, p.dims[2]), lo, hi);
      // each lane's first row of every column, all 27 loads issued before
      // any is used: mapping's columns rarely hold more than G rows
      float fx[9], fy[9], fz[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const int r = lo[c] + gl;
        fx[c] = fy[c] = fz[c] = 0.0f;
        if (r < hi[c]) {
          fx[c] = __ldg(g.points + 3 * static_cast<size_t>(r));
          fy[c] = __ldg(g.points + 3 * static_cast<size_t>(r) + 1);
          fz[c] = __ldg(g.points + 3 * static_cast<size_t>(r) + 2);
        }
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        if (lo[c] + gl < hi[c]) consider<K>(fx[c], fy[c], fz[c], lo[c] + gl, qx, qy, qz, p.r2, bd, br);
      }
      // the rest of each column, kUnroll rows a lane loaded together
      // (odometry's columns hold hundreds)
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        for (int r0 = lo[c] + gl + G; r0 < hi[c]; r0 += kUnroll * G) {
          float x[kUnroll], y[kUnroll], z[kUnroll];
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            const int r = r0 + i * G;
            x[i] = y[i] = z[i] = 0.0f;
            if (r < hi[c]) {
              x[i] = __ldg(g.points + 3 * static_cast<size_t>(r));
              y[i] = __ldg(g.points + 3 * static_cast<size_t>(r) + 1);
              z[i] = __ldg(g.points + 3 * static_cast<size_t>(r) + 2);
            }
          }
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (r0 + i * G < hi[c]) consider<K>(x[i], y[i], z[i], r0 + i * G, qx, qy, qz, p.r2, bd, br);
          }
        }
      }
    }
  }

  // merge the group's G lists; lane j % G keeps rank j, and every lane
  // writes the ranks it keeps after the merge, all at once
  constexpr int kKeep = (K + G - 1) / G;
  float kd[kKeep];
  int kr[kKeep];
#pragma unroll
  for (int i = 0; i < kKeep; ++i) {
    kd[i] = CUDART_INF_F;
    kr[i] = kNone;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float d = bd[0];
    int r = br[0];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int orr = __shfl_xor_sync(0xffffffffu, r, off);
      if (before(od, orr, d, r)) {
        d = od;
        r = orr;
      }
    }
    if (r != kNone && br[0] == r) pop_head<K>(bd, br);
    if (gl == j % G) {
      kd[j / G] = d;
      kr[j / G] = r;
    }
  }
  if (q < p.nq) {
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const int j = i * G + gl;
      if (j < K) write_rank(g, extras, p, o, static_cast<size_t>(q) * K + j, kd[i], kr[i]);
    }
  }
}

using KernelFn = void (*)(Grid, const float*, const uint8_t*, const void*, KnnParams, Out, float*);

template <int K>
KernelFn pick_lanes(int lanes) {
  switch (lanes) {
    case 16: return knn_kernel<K, 16>;
    case 32: return knn_kernel<K, 32>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the k-NN on `stream`: k (5 or 8) neighbours per query, `lanes`
// (16 or 32) threads per query. `extras` may be null when n_extra is
// 0. The outputs are idx [nq, k] int32, dist [nq, k] float32, ok [nq, k]
// bool, pts [nq, k, 3] float32, out_extras [nq, k, n_extra] float32 and
// unresolved [] float32. Returns the launch's error (0 = ok).
int knn_fused_launch(const float* points, const int* point_idx, const int* starts, const int* counts,
                     const float* origin, const float* queries, const uint8_t* qmask, const void* extras,
                     const KnnParams* params, int k, int lanes, int* idx, float* dist, uint8_t* ok,
                     float* pts, float* out_extras, float* unresolved, void* stream) {
  const KnnParams p = *params;
  if (p.nq <= 0) return 0;
  KernelFn fn = k == 5 ? pick_lanes<5>(lanes) : k == 8 ? pick_lanes<8>(lanes) : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = kThreads / lanes;
  const int blocks = (p.nq + groups - 1) / groups;
  Grid g{points, point_idx, starts, counts, origin};
  Out o{idx, dist, ok, pts, out_extras};
  KnnParams pv = p;
  void* args[] = {&g, &queries, &qmask, &extras, &pv, &o, &unresolved};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks), dim3(kThreads), args,
                                           0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
