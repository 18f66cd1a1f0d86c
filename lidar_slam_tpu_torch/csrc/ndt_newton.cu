// The whole clamped-Newton NDT alignment in one launch, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/ndt_fused.py::ndt_reduce_fused
// TOGETHER WITH the lax.while_loop of
//   lidar_slam_tpu/models/registration/ndt.py::newton_align
// that calls it at every Newton evaluation (solver="newton",
// max_step_iterations == 0, every tracking configuration). On the TPU the
// counterpart is a Pallas kernel inside a jitted while_loop; here it is one
// persistent kernel that keeps the pose on the card. The loop is exactly
// the port's host newton_align (models/registration/ndt.py):
//   evaluate at the initial pose; while not converged and it <= max_iter:
//   unpivoted 6x6 LDL^T step (a zero or non-finite norm keeps the pose and
//   stops), flip a non-descent direction, alpha = clip(|step|, trans_eps/2,
//   step_size), p += alpha * direction, evaluate, converged = it >= 1 and
//   |alpha| < trans_eps (plus the score_rel_tol plateau), it += 1.
//
// What bounds it on an H100: at the tracking operating point an alignment
// is ~3-10 evaluations, each ~81 k (direct7) or ~314 k (radius27) independent
// (point, voxel) gathers -- 4 B of a 16.8 MB dense index, then a 64 B row
// of a 4.2 MB compact table, both resident in the 50 MB L2 -- and ~470
// fp32 FLOPs per accepted pair: about 0.2 us of FLOPs an evaluation. What
// held the port back was not that work but everything around it: a host
// loop that built the pose coefficients in numpy, launched two kernels,
// copied 32 sums back and solved the 6x6 system in Python, ~0.6 ms an
// evaluation against ~14 us on the card. The design:
//   - one cooperative launch per alignment and one copy of the result; the
//     pose, the sums and the solver state never leave the card;
//   - a persistent grid (resident blocks per SM x SMs) strides over
//     (point, stencil offset) pairs, so all of an evaluation's gathers are in
//     flight at once; the masked-in finite rows are compacted once, before
//     the loop (two grid barriers), so masked rows cost nothing afterwards;
//   - per evaluation ONE grid barrier: each block writes its 28 sums into a
//     column of a [28, blocks] partials table; after the barrier EVERY block
//     sums the table in the same fixed order and runs the same solver step
//     and pose math (one thread each: R, t, J[27], H[54] into shared
//     memory), so all blocks hold the same pose with no second barrier and
//     no broadcast. The table is double-buffered by the evaluation's parity:
//     a block overwrites a buffer only after the next barrier, which every
//     reader of that buffer has passed;
//   - fixed-order sums everywhere, so a rerun repeats to the bit.
// What is left is latency, not bandwidth or FLOPs: measured on an H100 an
// evaluation takes ~10 us (direct7): ~3.4 us of dependent gathers, ~1 us
// block reduction, ~1.5 us barrier, ~1.4 us summing the partials, ~2.6 us
// of one thread's solve and pose math (PERF.md).
// What does not serve: tensor cores (the per-pair work is 6-wide rank-1
// updates in fp32; fp32 has no tensor-core path and TF32 would break the
// parity tolerances) and TMA (the reads are scattered 64 B rows).
//
// The pose math and the solver follow the plain version's float32 operation
// order, every product and sum rounded on its own (__fmul_rn, __fadd_rn:
// nvcc would otherwise contract a*b + c into an FMA). The pose-coefficient
// expressions (ndt_reduce.cuh: pose_coefficients) are those of
// ops/cuda/ndt_newton.py::coefficient_terms, term for term
// (tests/test_torch_newton.py compares the texts).
//
// Build (plain C interface, loaded through ctypes; no torch headers; grid
// sync needs no -rdc since CUDA 11):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libndt_newton.so ndt_newton.cu

#include <cooperative_groups.h>

#include "ndt_reduce.cuh"

namespace cg = cooperative_groups;

// Per-alignment constants (ctypes mirror in ops/cuda/ndt_newton.py: _Params).
struct NdtNewtonParams {
  ndt::GridConsts g;
  int n;  // source rows
  int max_iter;
  float trans_eps;
  float step_min;  // trans_eps / 2
  float step_max;  // step_size
  float score_rel_tol;
};

namespace {

using namespace ndt;

constexpr int kMinBlocks = 2;  // resident blocks per SM the registers are capped for
constexpr int kNOut = 48;      // ops/cuda/ndt_newton.py: POSE ... N_VALID, ROTATION, 1 pad

struct Args {
  const float* points;  // [n, 3]
  const uint8_t* mask;  // [n]
  const float* weights;  // [n]
  const int* index;  // [V] dense voxel -> packed row
  const float4* packed;  // [C+1, 16] as float4
  const float* pose0;  // [6]
  float4* compact;  // [n] scratch: masked-in finite rows (x, y, z, weight)
  int* counts;  // [2, blocks] scratch
  float* partials;  // [2, 28, blocks] scratch
  float* out;  // [kNOut]
  NdtNewtonParams p;
};

// The loop state; every block keeps its own identical copy in shared memory.
struct Newton {
  float p[6];   // current pose (tx, ty, tz, roll, pitch, yaw)
  float pe[6];  // pose of the pending evaluation
  float score;
  float grad[6];
  float H[36];
  float alpha;
  int it;
  int converged;
  int done;
  int first;
};

// delta = -H^-1 g: ops/cuda/ndt_newton.py::ldlt_solve in its operation order.
__device__ __forceinline__ void ldlt_solve(const float* H, const float* g, float* x) {
  float L[6][6], D[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j * 6 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(__fmul_rn(L[j][k], L[j][k]), D[k]));
    D[j] = s;
    const float inv_d = __fdiv_rn(1.0f, s);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = __fsub_rn(t, __fmul_rn(__fmul_rn(L[i][k], L[j][k]), D[k]));
      L[i][j] = __fmul_rn(t, inv_d);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = __fsub_rn(t, __fmul_rn(L[i][k], y[k]));
    y[i] = t;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = __fdiv_rn(y[i], D[i]);
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t = __fsub_rn(t, __fmul_rn(L[k][i], x[k]));
    x[i] = t;
  }
}

// Takes the sums of the evaluation at s.pe and advances newton_align's loop
// to its next evaluation (s.pe) or to its end (s.done). One thread of every
// block runs it on identical inputs.
__device__ __noinline__ void newton_step(Newton& s, const float* sums, const NdtNewtonParams& P) {
  if (!s.first) {  // the iteration that evaluated at s.pe ends
    int conv = s.it >= 1 && fabsf(s.alpha) < P.trans_eps;
    if (P.score_rel_tol > 0.0f)
      conv |= s.it >= 3 &&
              fabsf(__fsub_rn(sums[0], s.score)) < __fmul_rn(P.score_rel_tol, fmaxf(fabsf(s.score), 1e-6f));
    s.converged = conv;
#pragma unroll
    for (int i = 0; i < 6; ++i) s.p[i] = s.pe[i];
    s.it += 1;
  }
  s.first = 0;
  s.score = sums[0];
#pragma unroll
  for (int i = 0; i < 6; ++i) s.grad[i] = sums[1 + i];
  int u = 7;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++u) s.H[i * 6 + j] = s.H[j * 6 + i] = sums[u];

  for (;;) {
    if (s.converged || s.it > P.max_iter) {
      s.done = 1;
      return;
    }
    float delta[6];
    ldlt_solve(s.H, s.grad, delta);
    float dn2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) dn2 = __fadd_rn(dn2, __fmul_rn(delta[i], delta[i]));
    const float dnorm = __fsqrt_rn(dn2);
    if (dnorm == 0.0f || !isfinite(dnorm)) {  // degenerate step: keep the pose, stop
      s.converged = 1;
      s.it += 1;
      continue;
    }
    float dir[6], slope = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      dir[i] = __fdiv_rn(delta[i], dnorm);
      slope = __fadd_rn(slope, __fmul_rn(s.grad[i], dir[i]));
    }
    const bool flip = -slope > 0.0f;  // d_phi_0 = -grad . dir > 0: not a descent direction
    const float alpha = fminf(fmaxf(dnorm, P.step_min), P.step_max);
#pragma unroll
    for (int i = 0; i < 6; ++i) s.pe[i] = __fadd_rn(s.p[i], __fmul_rn(alpha, flip ? -dir[i] : dir[i]));
    s.alpha = alpha;
    return;
  }
}

__device__ __forceinline__ bool row_finite(const float* points, int r, float& x, float& y, float& z) {
  x = points[3 * r];
  y = points[3 * r + 1];
  z = points[3 * r + 2];
  return isfinite(x) && isfinite(y) && isfinite(z);
}

// Sums three ints over the block; every thread gets the totals.
__device__ __forceinline__ void block_sum3(int (&v)[3], int (*scratch)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], s);
    if (lane == 0) scratch[warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v[k] += scratch[w][k];
  }
  __syncthreads();
}

template <int NOFF>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ndt_newton_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float coef[kNCoef];
  __shared__ float warp_sums[kWarps][kNAcc];
  __shared__ float sums[kNAcc];
  __shared__ int scratch[kWarps][3];
  __shared__ Newton st;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const NdtNewtonParams& P = a.p;

  // 1. Compact the masked-in finite rows, in row order: block b owns rows
  //    [r0, r1), counts them, and after a barrier writes them from its
  //    offset on. The masked-in count (finite or not) is the n_valid of
  //    trans_probability.
  const int chunk = (P.n + G - 1) / G;
  const int r0 = min(P.n, b * chunk), r1 = min(P.n, r0 + chunk);
  int n_ok = 0, n_mask = 0;
  for (int base = r0; base < r1; base += kThreads) {
    const int r = base + tid;
    float x, y, z;
    const bool m = r < r1 && a.mask[r] != 0;
    const bool ok = m && row_finite(a.points, r, x, y, z);
    n_ok += __syncthreads_count(ok);
    n_mask += __syncthreads_count(m);
  }
  if (tid == 0) {
    a.counts[b] = n_ok;
    a.counts[G + b] = n_mask;
  }
  grid.sync();
  int tot[3] = {0, 0, 0};  // rows before this block's, all rows, masked-in rows
  for (int j = tid; j < G; j += kThreads) {
    const int c = __ldcg(a.counts + j);
    tot[0] += j < b ? c : 0;
    tot[1] += c;
    tot[2] += __ldcg(a.counts + G + j);
  }
  block_sum3(tot, scratch);
  int pos = tot[0];
  for (int base = r0; base < r1; base += kThreads) {
    const int r = base + tid;
    float x, y, z;
    const bool ok = r < r1 && a.mask[r] != 0 && row_finite(a.points, r, x, y, z);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) scratch[warp][0] = __popc(ballot);
    __syncthreads();
    int off = pos, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? scratch[w][0] : 0;
      tile += scratch[w][0];
    }
    if (ok) a.compact[off + __popc(ballot & ((1u << lane) - 1u))] = make_float4(x, y, z, a.weights[r]);
    pos += tile;
    __syncthreads();
  }
  grid.sync();

  // 2. The Newton loop: one evaluation and one grid barrier per iteration.
  const int n_items = tot[1] * NOFF;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) st.p[i] = st.pe[i] = a.pose0[i];
    st.alpha = 0.0f;
    st.it = st.converged = st.done = 0;
    st.first = 1;
    pose_coefficients(st.pe, coef);
  }
  __syncthreads();
  for (int e = 0;; ++e) {
    float acc[kNAcc];
#pragma unroll
    for (int k = 0; k < kNAcc; ++k) acc[k] = 0.0f;
    // every thread of a block runs the same trip count (ndt_reduce.cuh)
    for (int base = b * kThreads; base < n_items; base += G * kThreads) {
      const int i = base + tid;
      if (i >= n_items) continue;
      const int row = i / NOFF;
      accumulate_pair<NOFF>(__ldcg(a.compact + row), i - row * NOFF, a.index, a.packed, coef, P.g, acc);
    }
    float* table = a.partials + (e & 1) * kNAcc * G;
    block_reduce_store(acc, warp_sums, table + b, G);
    grid.sync();
    sum_partials(table, G, sums);
    __syncthreads();
    if (tid == 0) {
      newton_step(st, sums, P);
      if (!st.done) pose_coefficients(st.pe, coef);
    }
    __syncthreads();
    if (st.done) break;
  }

  if (b == 0 && tid == 0) {
    float* o = a.out;
#pragma unroll
    for (int i = 0; i < 6; ++i) o[i] = st.p[i];
    o[6] = st.score;
#pragma unroll
    for (int i = 0; i < 6; ++i) o[7 + i] = st.grad[i];
    int u = 13;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j, ++u) o[u] = st.H[i * 6 + j];
    o[34] = static_cast<float>(st.it);
    o[35] = static_cast<float>(st.converged);
    o[36] = 0.0f;  // unresolved: the direct gather never drops a term
    o[37] = static_cast<float>(tot[2]);
    // coef holds the last evaluated pose's coefficients, and that pose is st.p
    for (int i = 0; i < 9; ++i) o[38 + i] = coef[kR + i];
    for (int i = 47; i < kNOut; ++i) o[i] = 0.0f;
  }
}

__global__ void pose_coefficients_kernel(const float* __restrict__ pose, float* __restrict__ out) {
  float p[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) p[i] = pose[i];
  pose_coefficients(p, out);
}

template <int NOFF>
int resident_blocks() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ndt_newton_kernel<NOFF>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    resident = sms * per_sm;
  }
  return resident;
}

}  // namespace

extern "C" {

// The persistent grid: as many blocks as can be resident at once (0 if the
// card could not be queried).
int ndt_newton_blocks(int n_off) {
  if (n_off == 7) return resident_blocks<7>();
  if (n_off == 27) return resident_blocks<27>();
  return 0;
}

// Launches the alignment on `stream` as a cooperative kernel. Scratch:
// `compact` max(n, 1) * 4 floats, `counts` 2 * blocks ints, `partials`
// 2 * 28 * blocks floats; `out` 48 floats. Returns the launch's error (0 =
// ok; a grid too large for co-residency is cudaErrorCooperativeLaunchTooLarge).
int ndt_newton_launch(const float* points, const uint8_t* mask, const float* weights,
                      const int* index, const float* packed, const float* pose0,
                      const NdtNewtonParams* params, int n_off, int blocks, float* compact,
                      int* counts, float* partials, float* out, void* stream) {
  Args a = {points, mask, weights, index, reinterpret_cast<const float4*>(packed), pose0,
            reinterpret_cast<float4*>(compact), counts, partials, out, *params};
  void* args[] = {&a};
  const void* fn = nullptr;
  if (n_off == 7) fn = reinterpret_cast<const void*>(&ndt_newton_kernel<7>);
  if (n_off == 27) fn = reinterpret_cast<const void*>(&ndt_newton_kernel<27>);
  if (fn == nullptr || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The device pose math alone, on one thread: out[93] = R, t, J, H of pose[6].
int ndt_pose_coefficients_launch(const float* pose, float* out, void* stream) {
  pose_coefficients_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(pose, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
