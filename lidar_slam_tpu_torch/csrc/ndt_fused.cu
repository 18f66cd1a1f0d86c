// Fused NDT score / gradient / Hessian reduction for NVIDIA Hopper (sm_90a):
// one derivative evaluation at a given pose, in one launch.
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/ndt_fused.py::ndt_reduce_fused
// (wrapper lidar_slam_tpu/models/registration/ndt.py::_ndt_derivatives_fused).
// It computes what that kernel computes, not how (ndt_reduce.cuh says what):
// the TPU kernel's one-hot MXU selection over per-group key windows, the x8
// sublane relayout and the permutation matmul exist only because Mosaic has
// no VMEM gather. Here each pair gathers directly, the way the XLA
// `two_level` path does: 4 B from the dense voxel index, then the packed
// 64 B stats row (read as float4). So `unresolved` (output slot 28) is 0 by
// construction; it is kept so callers keep their check.
//
// Since the clamped-Newton alignment moved onto the card (ndt_newton.cu),
// this one-shot form serves ndt_derivatives and the host loop of the
// More-Thuente line search (max_step_iterations > 0). The pose comes either
// as host-computed coefficients in the launch arguments, or as a [6] pose on
// the card (`pose` not null): each block then computes the coefficients
// itself (ndt_reduce.cuh: pose_coefficients), so a chain of evaluations whose
// pose depends on the last one's sums needs no host read (the bench's
// evaluation probe).
//
// Design: a grid of up to as many blocks as can be resident strides over
// the (point, stencil offset) pairs; masked and non-finite points leave at
// once. Each block writes one column of a [28, blocks] partials table; the
// last block to finish (an atomic ticket after __threadfence) sums the
// table in a fixed order. The ticket is the caller's scratch of this call,
// zeroed on the launch stream just before the kernel, so launches on other
// streams never share it. One launch, no atomics on the sums, so the result
// is identical from run to run.
//
// What bounds it on an H100: at the tracking operating point one
// evaluation reads 32 768 rows (0.56 MB), the touched words of a 16.8 MB
// dense index and rows of a 4.2 MB compact table (both L2-resident), and
// does ~400 fp32 FLOPs per accepted pair: ~1 us of bytes or FLOPs. Far too
// little work to fill the card, so it is latency- and launch-bound; the
// pair-level parallelism is what the design does about the latency. No
// tensor cores (the per-pair work is 6-wide rank-1 updates in fp32; TF32
// would break the parity tolerances) and no TMA (the reads are scattered
// 64 B rows). Measured numbers are in PERF.md.
//
// Build (plain C interface, loaded through ctypes; no torch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libndt_fused.so ndt_fused.cu

#include "ndt_reduce.cuh"

// Per-evaluation constants, passed by value as a kernel argument. The host
// fills it (ctypes mirror in ops/cuda/ndt_fused.py: _Params); all fields are
// 4 bytes, so the layout has no padding. R, t, J, H are the pose
// coefficients in ndt_reduce.cuh's order.
struct NdtFusedParams {
  float R[9];
  float t[3];
  float J[27];
  float H[54];
  float origin[3];
  float res;
  float res2;
  float d1;
  float d2;
  int dims[3];
  int n;  // number of source points
  int weight_derivatives;
};

namespace {

using namespace ndt;

constexpr int kNOut = 32;  // + unresolved (slot 28, always 0) + 3 pad

template <int NOFF>
__global__ void __launch_bounds__(kThreads, 2)
    ndt_fused_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
                     const float* __restrict__ weights, const int* __restrict__ index,
                     const float4* __restrict__ packed, const __grid_constant__ NdtFusedParams p,
                     const float* __restrict__ pose, float* __restrict__ partials,
                     unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float coef[kNCoef];
  __shared__ float warp_sums[kWarps][kNAcc];
  __shared__ float sums[kNAcc];
  __shared__ bool is_last;
  if (pose != nullptr) {
    if (threadIdx.x == 0) {
      float pe[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) pe[i] = pose[i];
      pose_coefficients(pe, coef);
    }
  } else {
    // R, t, J, H lead the struct, contiguous (read in place: __grid_constant__)
    for (int i = threadIdx.x; i < kNCoef; i += kThreads) coef[i] = reinterpret_cast<const float*>(&p)[i];
  }
  const GridConsts g = {{p.origin[0], p.origin[1], p.origin[2]}, p.res, p.res2, p.d1, p.d2,
                        {p.dims[0], p.dims[1], p.dims[2]}, p.weight_derivatives};
  __syncthreads();

  float acc[kNAcc];
#pragma unroll
  for (int k = 0; k < kNAcc; ++k) acc[k] = 0.0f;
  const int n_items = p.n * NOFF;
  // every thread of a block runs the same trip count (ndt_reduce.cuh)
  for (int base = blockIdx.x * kThreads; base < n_items; base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    if (i >= n_items) continue;
    const int row = i / NOFF;
    if (mask[row] == 0) continue;
    const float x = points[3 * row], y = points[3 * row + 1], z = points[3 * row + 2];
    // non-finite points contribute nothing (the reference's isfinite guard)
    if (!(isfinite(x) && isfinite(y) && isfinite(z))) continue;
    accumulate_pair<NOFF>(make_float4(x, y, z, weights[row]), i - row * NOFF, index, packed, coef, g,
                          acc);
  }
  block_reduce_store(acc, warp_sums, partials + blockIdx.x, gridDim.x);

  // the last block to arrive sums the table (threadFenceReduction pattern)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  sum_partials(partials, gridDim.x, sums);
  __syncthreads();
  if (threadIdx.x < kNOut) out[threadIdx.x] = threadIdx.x < kNAcc ? sums[threadIdx.x] : 0.0f;
}

template <int NOFF>
int grid_blocks(int n) {
  static int resident = 0;  // blocks that fit on the card at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ndt_fused_kernel<NOFF>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    resident = sms * per_sm;
  }
  const long long want = (static_cast<long long>(n) * NOFF + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < resident ? want : resident));
}

}  // namespace

extern "C" {

// Blocks of a launch for n points: one column each of the partials table.
// 0 if the card could not be queried.
int ndt_fused_blocks(int n, int n_off) {
  if (n_off == 7) return grid_blocks<7>(n);
  if (n_off == 27) return grid_blocks<27>(n);
  return 0;
}

// Launches the reduction on `stream`. `pose` is null (params carries the
// pose coefficients) or [6] floats on the card (params' R, t, J, H are not
// read). `partials` holds blocks * 28 floats of scratch and `ticket` one
// word of scratch, both owned by this call; the ticket is zeroed on
// `stream` before the kernel. `out` holds 32 floats. Returns the first CUDA
// error (0 = ok).
int ndt_fused_launch(const float* points, const uint8_t* mask, const float* weights,
                     const int* index, const float* packed, const NdtFusedParams* params,
                     const float* pose, int n_off, int blocks, float* partials,
                     unsigned int* ticket, float* out, void* stream) {
  const NdtFusedParams p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* packed4 = reinterpret_cast<const float4*>(packed);
  if (blocks < 1 || (n_off != 7 && n_off != 27)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t zeroed = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (n_off == 7) {
    ndt_fused_kernel<7><<<blocks, kThreads, 0, s>>>(points, mask, weights, index, packed4, p, pose,
                                                    partials, ticket, out);
  } else {
    ndt_fused_kernel<27><<<blocks, kThreads, 0, s>>>(points, mask, weights, index, packed4, p, pose,
                                                     partials, ticket, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
