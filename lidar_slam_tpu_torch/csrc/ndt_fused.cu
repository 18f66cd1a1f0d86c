// Fused NDT score / gradient / Hessian reduction for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/ndt_fused.py::ndt_reduce_fused
// (wrapper lidar_slam_tpu/models/registration/ndt.py::_ndt_derivatives_fused).
// It computes what that kernel computes, not how: the weighted Magnusson NDT
// score, gradient[6] and upper-triangular Hessian[21], summed over every
// (source point, stencil voxel) pair, gated on a valid voxel, d2*exp in
// [0, 1] and finite, and (radius27 only) |x' - mu|^2 <= res^2.
//
// What was dropped: the TPU kernel's one-hot MXU selection over per-group
// key windows, the x8 sublane relayout and the permutation matmul exist
// only because Mosaic has no VMEM gather. Here each thread gathers directly,
// the way the XLA `two_level` path does: 4 B from the dense voxel index,
// then the packed 64 B stats row (read as float4). So `unresolved` (output
// slot 28) is 0 by construction; it is kept so callers keep their check.
//
// Design: one thread per source point. The thread transforms its raw point
// with the pose coefficients (kernel arguments), builds its 9 rotation-
// Jacobian and 18 rotation-Hessian rows in registers (fusing away the
// [31, N] per-point row stack the TPU wrapper materialised), loops over the
// 7 or 27 stencil offsets (a template parameter, fully unrolled) and
// accumulates 28 floats in registers. Each block reduces with warp shuffles
// and shared memory and writes one [32] partial; a second one-block kernel
// sums the partials in a fixed order, so the result is identical from run
// to run (no atomics), and so are the trajectories that consume it.
//
// What bounds it on an H100: at the tracking operating point one evaluation
// is 32 768 points x 7 lookups, ~15 MB of scattered reads from a 16.8 MB
// dense index (4.19 M voxels) plus a 4.2 MB compact table (65 537 rows) --
// both fit in the 50 MB L2 -- and ~46 MFLOP of arithmetic. That is far too
// little work to fill the card: expect the kernel to be latency- and
// launch-bound (a few tens of microseconds), and the per-iteration host
// synchronisation of the Newton loop to dominate the frame. Not optimised
// yet; measured numbers are in PERF.md.
//
// Build (plain C interface, loaded through ctypes; no torch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libndt_fused.so ndt_fused.cu
// No --use_fast_math: expf and the divisions stay IEEE, as on the reference.

#include <cuda_runtime.h>
#include <stdint.h>

// Per-evaluation constants, passed by value as a kernel argument. The host
// fills it (ctypes mirror in ops/cuda/ndt_fused.py: _Params); all fields are
// 4 bytes, so the layout has no padding.
struct NdtFusedParams {
  float R[9];       // rotation, row-major
  float t[3];       // translation
  float J[27];      // jrot(r, a) = J[(3r+a)*3 + j] . x   (x = raw point)
  float H[54];      // hrot(pair k, r) = H[(3k+r)*3 + j] . x, pairs 00 01 02 11 12 22
  float origin[3];  // grid min corner (metres)
  float res;        // voxel edge
  float res2;       // radius27 gate, res^2
  float d1;         // Gaussian-mixture constants (Magnusson 2009, eq. 6.8)
  float d2;
  int dims[3];      // grid dims, flat voxel id = (x * dims[1] + y) * dims[2] + z
  int n;            // number of source points
  int weight_derivatives;  // 1: voxel static weight also scales grad/Hessian
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNAcc = 28;  // score, grad[6], Hessian upper triangle[21]
constexpr int kNOut = 32;  // + unresolved (slot 28, always 0) + 3 pad

template <int NOFF>
struct Stencil;

// centre + 6 face neighbours, ungated (the order of the reference's _stencil7)
template <>
struct Stencil<7> {
  static constexpr bool kRadiusGate = false;
  __device__ __forceinline__ static void offset(int o, int& x, int& y, int& z) {
    x = (o == 1) - (o == 2);
    y = (o == 3) - (o == 4);
    z = (o == 5) - (o == 6);
  }
};

// 3x3x3 block, x-major like the reference's meshgrid(indexing="ij"), gated
// by |x' - mu| <= res (radiusSearch semantics)
template <>
struct Stencil<27> {
  static constexpr bool kRadiusGate = true;
  __device__ __forceinline__ static void offset(int o, int& x, int& y, int& z) {
    x = o / 9 - 1;
    y = (o / 3) % 3 - 1;
    z = o % 3 - 1;
  }
};

__device__ __forceinline__ int clamp_cell(int c, int dim) {
  // cells further than one outside the grid have no in-bounds neighbour;
  // clamping keeps c + offset from overflowing for far-away points
  return min(max(c, -2), dim + 1);
}

template <int NOFF>
__device__ __forceinline__ void accumulate_point(float x, float y, float z, float pw,
                                                 const int* __restrict__ index,
                                                 const float4* __restrict__ packed,
                                                 const NdtFusedParams& p, float (&acc)[kNAcc]) {
  const float xp0 = p.R[0] * x + p.R[1] * y + p.R[2] * z + p.t[0];
  const float xp1 = p.R[3] * x + p.R[4] * y + p.R[5] * z + p.t[1];
  const float xp2 = p.R[6] * x + p.R[7] * y + p.R[8] * z + p.t[2];

  float jr[3][3];  // jr[r][a]: row r of the rotation Jacobian, angle a
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* c = p.J + (3 * r + a) * 3;
      jr[r][a] = c[0] * x + c[1] * y + c[2] * z;
    }
  float hr[6][3];  // hr[k][r]: component r of the angle-pair k second derivative
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* c = p.H + (3 * k + r) * 3;
      hr[k][r] = c[0] * x + c[1] * y + c[2] * z;
    }

  const int cx = clamp_cell(static_cast<int>(floorf((xp0 - p.origin[0]) / p.res)), p.dims[0]);
  const int cy = clamp_cell(static_cast<int>(floorf((xp1 - p.origin[1]) / p.res)), p.dims[1]);
  const int cz = clamp_cell(static_cast<int>(floorf((xp2 - p.origin[2]) / p.res)), p.dims[2]);

#pragma unroll
  for (int o = 0; o < NOFF; ++o) {
    int ox, oy, oz;
    Stencil<NOFF>::offset(o, ox, oy, oz);
    const int nx = cx + ox, ny = cy + oy, nz = cz + oz;
    if (nx < 0 || nx >= p.dims[0] || ny < 0 || ny >= p.dims[1] || nz < 0 || nz >= p.dims[2])
      continue;
    const int row = __ldg(index + (nx * p.dims[1] + ny) * p.dims[2] + nz);
    // packed row: [0:3] mean, [3] static weight, [4:10] icov upper
    // (xx xy xz yy yz zz), [10] valid, [11] count, [12:16] pad
    const float4 s0 = __ldg(packed + 4 * row);
    const float4 s1 = __ldg(packed + 4 * row + 1);
    const float4 s2 = __ldg(packed + 4 * row + 2);
    if (!(s2.z > 0.5f)) continue;

    const float e0 = xp0 - s0.x, e1 = xp1 - s0.y, e2 = xp2 - s0.z;
    if (Stencil<NOFF>::kRadiusGate && !(e0 * e0 + e1 * e1 + e2 * e2 <= p.res2)) continue;

    const float ci[3][3] = {{s1.x, s1.y, s1.z}, {s1.y, s1.w, s2.x}, {s1.z, s2.x, s2.y}};
    const float q0 = ci[0][0] * e0 + ci[0][1] * e1 + ci[0][2] * e2;
    const float q1 = ci[1][0] * e0 + ci[1][1] * e1 + ci[1][2] * e2;
    const float q2 = ci[2][0] * e0 + ci[2][1] * e1 + ci[2][2] * e2;
    const float md = q0 * e0 + q1 * e1 + q2 * e2;
    const float expt = expf(-0.5f * p.d2 * md);
    const float exd = p.d2 * expt;
    // updateDerivatives' guard: d2 * exp(...) in [0, 1] and finite
    if (!(exd <= 1.0f && exd >= 0.0f && isfinite(exd))) continue;

    const float sv = s0.w;
    acc[0] += sv * pw * (-p.d1) * expt;
    const float f = (p.weight_derivatives ? sv * pw : pw) * p.d1 * p.d2 * expt;

    // qJ columns: p < 3 -> q_p; p = 3 + a -> sum_r q_r jr[r][a]
    const float qj[6] = {q0, q1, q2,
                         q0 * jr[0][0] + q1 * jr[1][0] + q2 * jr[2][0],
                         q0 * jr[0][1] + q1 * jr[1][1] + q2 * jr[2][1],
                         q0 * jr[0][2] + q1 * jr[1][2] + q2 * jr[2][2]};
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[1 + k] += f * qj[k];

    float cj[3][3];  // cj[r][a] = (Cinv jrot_a)[r]
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        cj[r][a] = ci[r][0] * jr[0][a] + ci[r][1] * jr[1][a] + ci[r][2] * jr[2][a];

    int u = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j, ++u) {
        // h1 = -d2 f qJ_i qJ_j ; h3 = f (J^T Cinv J)_ij ; h2 = f q . hrot_ab
        float term = -p.d2 * f * qj[i] * qj[j];
        if (j < 3) {
          term += f * ci[i][j];
        } else if (i < 3) {
          term += f * cj[i][j - 3];
        } else {
          const int a = i - 3, b = j - 3;  // a <= b
          const int k = a * 3 - a * (a - 1) / 2 + (b - a);
          term += f * (jr[0][a] * cj[0][b] + jr[1][a] * cj[1][b] + jr[2][a] * cj[2][b]);
          term += f * (q0 * hr[k][0] + q1 * hr[k][1] + q2 * hr[k][2]);
        }
        acc[7 + u] += term;
      }
  }
}

__device__ __forceinline__ void block_reduce_store(float (&acc)[kNAcc], float* __restrict__ out) {
  __shared__ float warp_sums[kWarps][kNAcc];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNOut) {
    float v = 0.0f;
    if (threadIdx.x < kNAcc) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    }
    out[threadIdx.x] = v;  // slots 28..31: unresolved (0) and pad
  }
}

template <int NOFF>
__global__ void __launch_bounds__(kThreads)
    ndt_fused_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
                     const float* __restrict__ weights, const int* __restrict__ index,
                     const float4* __restrict__ packed, const NdtFusedParams p,
                     float* __restrict__ partials) {
  float acc[kNAcc];
#pragma unroll
  for (int k = 0; k < kNAcc; ++k) acc[k] = 0.0f;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < p.n) {
    const float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
    // masked and non-finite points contribute nothing (the reference's
    // isfinite guard on the source cloud)
    if (mask[i] != 0 && isfinite(x) && isfinite(y) && isfinite(z))
      accumulate_point<NOFF>(x, y, z, weights[i], index, packed, p, acc);
  }
  block_reduce_store(acc, partials + blockIdx.x * kNOut);
}

// one warp per output slot, each summing the block partials in a fixed order
__global__ void __launch_bounds__(32 * kNOut)
    reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                           float* __restrict__ out) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.0f;
  for (int b = lane; b < n_blocks; b += 32) v += partials[b * kNOut + k];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  if (lane == 0) out[k] = v;
}

}  // namespace

extern "C" {

int ndt_fused_blocks(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

// Launches the reduction on `stream`; `partials` holds ndt_fused_blocks(n) * 32
// floats of scratch, `out` 32 floats. Returns cudaGetLastError() (0 = ok).
int ndt_fused_launch(const float* points, const uint8_t* mask, const float* weights,
                     const int* index, const float* packed, const NdtFusedParams* params, int n_off,
                     float* partials, float* out, void* stream) {
  const NdtFusedParams p = *params;
  const int blocks = ndt_fused_blocks(p.n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* packed4 = reinterpret_cast<const float4*>(packed);
  if (n_off == 7) {
    ndt_fused_kernel<7><<<blocks, kThreads, 0, s>>>(points, mask, weights, index, packed4, p,
                                                    partials);
  } else if (n_off == 27) {
    ndt_fused_kernel<27><<<blocks, kThreads, 0, s>>>(points, mask, weights, index, packed4, p,
                                                     partials);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<1, 32 * kNOut, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
