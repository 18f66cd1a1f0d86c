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
// The work: at the tracking operating point an alignment is ~3-30
// evaluations, each ~81 k (direct7) or ~314 k (radius27) independent
// (point, voxel) pairs -- a 16 B compacted source row, 4 B of a 16.8 MB
// dense index, then a 64 B row of a 4.2 MB compact table, all resident in
// the 50 MB L2 -- and ~470 fp32 FLOPs per accepted pair: ~0.2 us of FLOPs an
// evaluation. What bounds it on an H100 (measured by the stamps below,
// PERF.md): each trip of the grid's 67 584 pairs takes ~1.3-1.6 us however
// full it is, whatever the L1's size, whether the next trip's loads are
// issued early and whether the source rows come from shared memory or L2 --
// 2 trips (~3 us) an evaluation at direct7, 5 (~6.4 us) at radius27; most
// likely the SMs' issue of the divergent per-pair work (a warp runs a
// pair's whole path if one lane's pair is accepted) -- and around the
// gathers a serial tail of ~5 us an evaluation that the whole grid waits
// for: the block reduction (~0.8 us), the last block, the grid barrier
// (~1.0), the sum of the blocks' partial sums (~1.4), the solve and the
// next pose's coefficients (~1.5).
//
// The design, one cooperative launch per alignment and one copy of the
// result (the pose, the sums and the solver state never leave the card):
//   - a persistent grid (resident blocks per SM x SMs) strides over
//     (point, stencil offset) pairs, pair i = b*256 + tid + t*G*256 on trip
//     t, so all of an evaluation's gathers are in flight at once; the
//     masked-in finite rows are compacted once, before the loop (two grid
//     barriers), and read back through L2 (__ldcg: other blocks wrote them);
//   - per evaluation ONE grid barrier (cooperative groups' grid sync): each
//     block writes its 28 sums into a column of a [28, G] partials table
//     (double-buffered by the evaluation's parity: a block overwrites a
//     buffer only after the next barrier, which every reader of that buffer
//     has passed);
//   - after the barrier the C blocks of a thread-block cluster split the 28
//     rows: each sums its rows in ndt_reduce.cuh's sum_partials order (same
//     lane striding, chunks and butterfly: the same bits) and stores each
//     sum into the shared memory of every block of the cluster with
//     st.async (distributed shared memory), which counts its bytes on the
//     receiving block's mbarrier; the one thread that needs the sums waits
//     on its own block's barrier (112 bytes an evaluation), no cluster-wide
//     barrier (one cost ~0.6 us an evaluation more). The table's L2 reads
//     fall C-fold. C is the largest cluster for which
//     cudaOccupancyMaxActiveClusters x C is still the resident grid G (2 on
//     an H100: 132 clusters of 2 make its 264 blocks; 4 leave blocks out),
//     so the pair-to-block mapping, and with it every sum's bits, is the
//     unclustered kernel's;
//   - then every block runs the same solver step on identical inputs (one
//     thread: the 6x6 LDL^T is one dependent chain) and builds the next
//     pose's 93 coefficients on one warp (the table below), so all blocks
//     hold the same pose with no second barrier and no broadcast;
//   - fixed-order sums everywhere, so a rerun repeats to the bit.
// An evaluation's split by phase (gathers, block reduction, waiting for
// the last block, the barrier, the partial sums, step and pose) is
// measured on the card by the optional `stamps` (%globaltimer, block 0):
// chip_smoke.py phase 4 and chip_newton.py print it.
// What does not serve: tensor cores (the per-pair work is 6-wide rank-1
// updates in fp32; fp32 has no tensor-core path and TF32 would break the
// parity tolerances), TMA for the gathers (scattered 64 B rows), and
// warpgroup MMA. Tried and dropped (PERF.md, Findings): the block's
// source rows copied into shared memory once an alignment, saving a pair's
// first dependent L2 load (0.4-1.4 % of an alignment on an H100: not worth
// a 16 KB buffer and a second load path for larger clouds); and, as they
// did not move the gathers, prefetching the next trip's index word or row
// into L1, pipelining a pair's two loads across trips, and a larger L1.
//
// The pose math and the solver follow the plain version's float32 operation
// order, every product and sum rounded on its own (__fmul_rn, __fadd_rn:
// nvcc would otherwise contract a*b + c into an FMA). The pose-coefficient
// expressions are coefficient_terms.cuh's, the text ndt_reduce.cuh's
// pose_coefficients also includes.
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

// Never defined: a coefficient term the table below cannot code stops its
// compile-time evaluation here.
unsigned ndt_newton_unsupported_term();

namespace {

using namespace ndt;

constexpr int kMinBlocks = 2;  // resident blocks per SM the registers are capped for
constexpr int kNOut = 48;      // ops/cuda/ndt_newton.py: POSE ... N_VALID, ROTATION, 1 pad
constexpr int kMaxCluster = 8;  // the largest portable cluster
constexpr int kCodes = 96;     // a code per pose coefficient (93), three per lane of a warp
// stamps (ops/cuda/ndt_newton.py: STAMP_HEAD, STAMPS_PER_EVAL): [0] the
// evaluations, [1] kernel entry, [2] loop entry (rows compacted),
// then for evaluation e at kStampHead + kStampsPerEval * e the globaltimer
// (ns) when block 0's thread 0 is done with its gathers, block 0 is reduced,
// the last block is reduced (atomicMax over the blocks), block 0 is past the
// grid barrier, the 28 sums are in hand, the step and the next pose's
// coefficients are ready
constexpr int kStampHead = 3, kStampsPerEval = 6;

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

// ---- The pose math on one warp ----------------------------------------------
// Each R, J and H coefficient of pose_coefficients (ndt_reduce.cuh) is 0, a
// product of one to three factors, or the sum or difference of two such
// products; a factor is one of the 12 cosines and sines (ca ... sc of roll,
// pitch and yaw; cx ... sz the same snapped), perhaps negated. Compiled as
// they stand, the 90 expressions are 90 instruction streams, which the lanes
// of a warp would run one after another. So the host compiler evaluates
// their text (coefficient_terms.cuh, pose_coefficients' own lines) on
// symbols into one 32-bit code each: six 5-bit factors (0-11 a symbol,
// kOne the constant 1, + kNeg negated) and a 2-bit operation. Every lane of
// the warp then runs the same instructions on its own codes:
// ((f0 * f1) * f2) op ((f3 * f4) * f5). A product by 1 is exact, so each
// coefficient keeps the bits of its own expression.
namespace terms {

constexpr int kOne = 15, kNeg = 16;
enum Op : unsigned { kZero = 0, kProduct = 1, kSum = 2, kDifference = 3 };

constexpr unsigned require(bool ok) { return ok ? 0u : ndt_newton_unsupported_term(); }

struct Sym {
  int f;
};
constexpr Sym operator-(Sym s) { return Sym{s.f ^ kNeg}; }

struct Term {
  unsigned op = kZero;
  int n = 0;  // factors of the first product
  int f[2][3] = {{kOne, kOne, kOne}, {kOne, kOne, kOne}};
  constexpr Term() = default;
  constexpr Term(float zero) : op(require(zero == 0.0f) + kZero) {}
  constexpr Term(Sym s) : op(kProduct), n(1), f{{s.f, kOne, kOne}, {kOne, kOne, kOne}} {}
};

// a product times one more factor, from the left: ((a * b) * c)
constexpr Term mul(Term x, Term y) {
  require(x.op == kProduct && x.n < 3 && y.op == kProduct && y.n == 1);
  x.f[0][x.n++] = y.f[0][0];
  return x;
}

constexpr Term combine(unsigned op, Term x, const Term& y) {
  require(x.op == kProduct && y.op == kProduct);
  x.op = op;
  for (int i = 0; i < 3; ++i) x.f[1][i] = y.f[0][i];
  return x;
}

constexpr Term add(Term x, Term y) { return combine(kSum, x, y); }
constexpr Term sub(Term x, Term y) { return combine(kDifference, x, y); }

struct Table {
  Term c[kNCoef];
};

#pragma push_macro("__fmul_rn")
#pragma push_macro("__fadd_rn")
#pragma push_macro("__fsub_rn")
#undef __fmul_rn
#undef __fadd_rn
#undef __fsub_rn
#define __fmul_rn(x, y) mul(x, y)
#define __fadd_rn(x, y) add(x, y)
#define __fsub_rn(x, y) sub(x, y)
constexpr Table table() {
  Table t{};
  Term* c = t.c;
  const Sym ca{0}, sa{1}, cb{2}, sb{3}, cc{4}, sc{5}, cx{6}, sx{7}, cy{8}, sy{9}, cz{10}, sz{11};
#include "coefficient_terms.cuh"
  return t;
}
#pragma pop_macro("__fsub_rn")
#pragma pop_macro("__fadd_rn")
#pragma pop_macro("__fmul_rn")

struct Codes {
  unsigned k[kCodes];
};

// The table's codes, coefficient by coefficient (the t slots stay 0: the
// lanes copy the pose there).
constexpr Codes codes() {
  const Table t = table();
  Codes out{};
  for (int i = 0; i < kNCoef; ++i) {
    unsigned k = t.c[i].op << 30;
    for (int j = 0; j < 6; ++j) k |= static_cast<unsigned>(t.c[i].f[j / 3][j % 3]) << (5 * j);
    out.k[i] = k;
  }
  return out;
}

}  // namespace terms

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
  long long* stamps;  // null, or kStampHead + kStampsPerEval * (max_iter + 2) zeros
  NdtNewtonParams p;
  terms::Codes codes;  // terms::codes()
};

// R, t, J, H of pose p (shared memory) into c, on the 32 lanes of a warp:
// lane l computes coefficients l, l + 32 and l + 64 from `code` (its three
// terms::codes()), with pose_coefficients' float operations in its order.
__device__ __forceinline__ void warp_pose_coefficients(const float* p, const unsigned (&code)[3], float* c) {
  const unsigned lane = threadIdx.x & 31u;
  // lanes 0-5 hold ca = cosf(p[3]), sa = sinf(p[3]), cb, sb, cc, sc (sincosf: the bits of sinf and
  // cosf, in one evaluation on every lane)
  const float ang = p[3 + min(lane >> 1, 2u)];
  float sv, cv;
  sincosf(ang, &sv, &cv);
  const float trig = lane & 1u ? sv : cv;
  // the derivative coefficients snap angles below 1e-4 to exactly 0
  const unsigned snap = (fabsf(p[3]) < 1e-4f) | (fabsf(p[4]) < 1e-4f) << 1 | (fabsf(p[5]) < 1e-4f) << 2;
  auto factor = [&](unsigned f) {
    const unsigned s = f & 15u;
    float v = __shfl_sync(0xffffffffu, trig, s < 6u ? s : s - 6u);
    if (s >= 6u && s < 12u && (snap >> ((s - 6u) >> 1) & 1u)) v = s & 1u ? 0.0f : 1.0f;  // cx = snap_x ? 1 : ca
    if (s == terms::kOne) v = 1.0f;
    return f & terms::kNeg ? -v : v;
  };
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const unsigned k = lane + 32u * r, cd = code[r];
    const float p1 = __fmul_rn(__fmul_rn(factor(cd), factor(cd >> 5)), factor(cd >> 10));
    const float p2 = __fmul_rn(__fmul_rn(factor(cd >> 15), factor(cd >> 20)), factor(cd >> 25));
    const unsigned op = cd >> 30;
    float v = op == terms::kSum ? __fadd_rn(p1, p2)
              : op == terms::kDifference ? __fsub_rn(p1, p2)
              : op == terms::kProduct ? p1 : 0.0f;
    if (k >= kT && k < kJ) v = p[k - kT];
    if (k < kNCoef) c[k] = v;
  }
}

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
// block runs it on identical inputs; inlined, so its arrays stay in
// registers.
__device__ __forceinline__ void newton_step(Newton& s, const float* sums, const NdtNewtonParams& P) {
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

// Shared-memory addresses for the PTX below: this block's, and block `rank`
// of the cluster's copy of the same variable.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// The cluster's share of the [28, n_cols] table: block q of a cluster of C
// sums rows q, q + C, ..., warp w taking the block's rows w, w + 8, ..., each
// in sum_partials' order (ndt_reduce.cuh: its lanes stride the columns in
// chunks of 512 columns, loads before adds, then the butterfly), and stores
// each sum into `sums` of every block of the cluster with st.async, which
// counts the 4 bytes on that block's `sums_full` barrier (28 x 4 bytes an
// evaluation: wait_sums).
__device__ __forceinline__ void cluster_sum_partials(unsigned q, unsigned C, const float* table, int n_cols,
                                                     float* sums, unsigned long long* sums_full) {
  constexpr int kRows = (kNAcc + kWarps - 1) / kWarps, kPerLane = 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
  for (int c0 = 0; c0 < n_cols; c0 += 32 * kPerLane) {
    float x[kRows][kPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int k = q + C * (warp + r * kWarps), c = c0 + j * 32 + lane;
        x[r][j] = k < kNAcc && c < n_cols ? __ldcg(table + k * n_cols + c) : 0.0f;
      }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[r] += x[r][j];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v[r] += __shfl_xor_sync(0xffffffffu, v[r], s);
    const int k = q + C * (warp + r * kWarps);
    if (lane == 0 && k < kNAcc)
      for (unsigned d = 0; d < C; ++d)
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                     :: "r"(cluster_addr(smem_addr(sums + k), d)), "r"(__float_as_uint(v[r])),
                        "r"(cluster_addr(smem_addr(sums_full), d))
                     : "memory");
  }
}

// Arms this block's `sums_full` barrier for the next evaluation: its one
// arrival, and the 28 x 4 bytes of the cluster's st.async stores to expect.
// Armed before any of those stores can be issued (they follow the next grid
// barrier), so the byte count never runs ahead of the stores.
__device__ __forceinline__ void expect_sums(unsigned long long* sums_full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(smem_addr(sums_full)), "r"(kNAcc * 4)
               : "memory");
}

// Waits (one thread) until this block's `sums` hold evaluation e's 28 sums:
// the completion of the barrier's phase e.
__device__ __forceinline__ void wait_sums(unsigned long long* sums_full, int e) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(sums_full)), "r"(static_cast<unsigned>(e & 1))
        : "memory");
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

template <int NOFF>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ndt_newton_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float coef[kNCoef];
  __shared__ float warp_sums[kWarps][kNAcc];
  __shared__ float sums[kNAcc];
  __shared__ unsigned long long sums_full;  // mbarrier: the cluster's stores into `sums`
  __shared__ int scratch[kWarps][3];
  __shared__ Newton st;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const NdtNewtonParams& P = a.p;
  long long* const stamps = b == 0 && tid == 0 ? a.stamps : nullptr;
  if (stamps) stamps[1] = global_ns();

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

  // 2. Warp 0 sets up the Newton loop: its state, the first pose's
  //    coefficients and the sums' barrier.
  const int n_rows = tot[1], n_items = n_rows * NOFF;
  unsigned code[3] = {0u, 0u, 0u};
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) code[r] = a.codes.k[lane + 32 * r];
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) st.p[i] = st.pe[i] = a.pose0[i];
      st.alpha = 0.0f;
      st.it = st.converged = st.done = 0;
      st.first = 1;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&sums_full)) : "memory");
      expect_sums(&sums_full);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    warp_pose_coefficients(st.pe, code, coef);
  }
  cluster.sync();  // every block's barrier initialised before the first store to it
  if (stamps) stamps[2] = global_ns();

  // 3. The Newton loop: one evaluation and one grid barrier per iteration.
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
    long long* const at = a.stamps && e < P.max_iter + 2 ? a.stamps + kStampHead + kStampsPerEval * e : nullptr;
    if (stamps && at) at[0] = global_ns();
    float* table = a.partials + (e & 1) * kNAcc * G;
    block_reduce_store(acc, warp_sums, table + b, G);
    if (at && tid == 0) {
      const long long now = global_ns();
      if (b == 0) at[1] = now;
      atomicMax(reinterpret_cast<unsigned long long*>(at + 2), static_cast<unsigned long long>(now));
    }
    grid.sync();
    if (stamps && at) at[3] = global_ns();
    cluster_sum_partials(cluster.block_rank(), cluster.num_blocks(), table, G, sums, &sums_full);
    if (warp == 0) {
      if (lane == 0) {
        wait_sums(&sums_full, e);
        expect_sums(&sums_full);
        if (stamps && at) at[4] = global_ns();
        newton_step(st, sums, P);
      }
      __syncwarp();
      if (!st.done) warp_pose_coefficients(st.pe, code, coef);
    }
    __syncthreads();
    if (stamps && at) at[5] = global_ns();
    if (st.done) {
      if (stamps) stamps[0] = e + 1;
      break;
    }
  }
  cluster.sync();  // no block leaves while a store of its cluster may still reach it

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

// The device pose math alone, as ndt_newton_kernel runs it (one warp).
__global__ void pose_coefficients_kernel(const float* __restrict__ pose, float* __restrict__ out,
                                         const __grid_constant__ terms::Codes codes) {
  __shared__ float p[6];
  const int lane = threadIdx.x;
  if (lane < 6) p[lane] = pose[lane];
  __syncwarp();
  unsigned code[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) code[r] = codes.k[lane + 32 * r];
  warp_pose_coefficients(p, code, out);
}

// The persistent grid: blocks resident per SM x SMs, and the largest
// cluster (<= kMaxCluster) whose resident clusters still fill
// exactly that grid.
struct GridShape {
  int blocks, cluster, clusters, per_sm, sms;
};

template <int NOFF>
cudaError_t grid_shape(GridShape& out) {
  static GridShape cached = {0, 0, 0, 0, 0};
  if (cached.blocks == 0) {
    const void* fn = reinterpret_cast<const void*>(&ndt_newton_kernel<NOFF>);
    GridShape s = {0, 1, 0, 0, 0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, fn, kThreads, 0);
    if (err != cudaSuccess) return err;
    s.blocks = s.clusters = s.sms * s.per_sm;
    for (int c = kMaxCluster; c > 1; c /= 2) {
      if (s.blocks % c != 0) continue;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = c;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(s.blocks);
      cfg.blockDim = dim3(kThreads);
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
      if (err != cudaSuccess) return err;
      if (n * c == s.blocks) {
        s.cluster = c;
        s.clusters = n;
        break;
      }
    }
    cached = s;
  }
  out = cached;
  return cudaSuccess;
}

cudaError_t grid_of(int n_off, GridShape& s, const void** fn) {
  if (n_off == 7) {
    *fn = reinterpret_cast<const void*>(&ndt_newton_kernel<7>);
    return grid_shape<7>(s);
  }
  if (n_off == 27) {
    *fn = reinterpret_cast<const void*>(&ndt_newton_kernel<27>);
    return grid_shape<27>(s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The kernel's grid for n_off stencil offsets: shape[0] blocks (as many as
// can be resident at once), [1] the cluster size, [2] the clusters resident
// at once, [3] blocks per SM, [4] SMs. Returns 0 or the CUDA error.
int ndt_newton_grid(int n_off, int* shape) {
  GridShape s;
  const void* fn = nullptr;
  const cudaError_t err = grid_of(n_off, s, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  shape[0] = s.blocks;
  shape[1] = s.cluster;
  shape[2] = s.clusters;
  shape[3] = s.per_sm;
  shape[4] = s.sms;
  return 0;
}

// Launches the alignment on `stream` as one cooperative kernel in clusters
// of ndt_newton_grid's size. `blocks` must be ndt_newton_grid's. Scratch:
// `compact` max(n, 1) * 4 floats, `counts` 2 * blocks ints, `partials`
// 2 * 28 * blocks floats; `out` 48 floats; `stamps` null or
// 3 + 6 * (max_iter + 2) zeroed int64. Returns the launch's error (0 = ok).
int ndt_newton_launch(const float* points, const uint8_t* mask, const float* weights,
                      const int* index, const float* packed, const float* pose0,
                      const NdtNewtonParams* params, int n_off, int blocks, float* compact,
                      int* counts, float* partials, float* out, long long* stamps, void* stream) {
  static constexpr terms::Codes kTermCodes = terms::codes();
  GridShape s;
  const void* fn = nullptr;
  cudaError_t err = grid_of(n_off, s, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks != s.blocks) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {points, mask, weights, index, reinterpret_cast<const float4*>(packed), pose0,
            reinterpret_cast<float4*>(compact), counts, partials, out, stamps, *params, kTermCodes};
  void* args[] = {&a};
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = s.cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The device pose math alone, on one warp: out[93] = R, t, J, H of pose[6].
int ndt_pose_coefficients_launch(const float* pose, float* out, void* stream) {
  static constexpr terms::Codes kTermCodes = terms::codes();
  pose_coefficients_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(pose, out, kTermCodes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
