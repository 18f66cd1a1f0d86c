// The pose graph's block-Jacobi preconditioned CG, one whole linear solve
// in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this solve as a
// lax.while_loop inside its jitted LM (lidar_slam_tpu/models/
// graph_optimizer.py::_solve_pcg), which XLA compiles into one device
// program. The port's plain version (models/graph_optimizer.py::_solve_pcg)
// issues each step as ~121 PyTorch launches, three of them sort-based
// index_put_ node sums in which every padded row of the fixed-capacity
// graph names node 0 and is added there in one serial run. This kernel
// solves (H + lam I) x = b on the free nodes from _assemble's per-edge and
// per-prior blocks, as _solve_pcg does:
//   b and the diagonal blocks D (node sums); Dinv = (D + (lam + 1e-8) I)^-1;
//   x = 0, r = b, p = z = Dinv r; each step while |r|^2 / |b|^2 > tol^2
//   and fewer than `iters` steps: Ap = (H + lam I) p, alpha = r.z / p.Ap,
//   x += alpha p, r -= alpha Ap, z = Dinv r, beta = r.z_new / r.z,
//   p = z + beta p.
// The loop stops where the JAX loop's condition fails; the port's plain
// version runs on with its state frozen, which gives the same x. The steps
// that worked are added to `active_steps`.
//
// The node sums follow incidence lists (ops/cuda/pose_pcg.py: incidence):
// for each node its valid edges where it is i, then those where it is j,
// then its valid priors, each group in input order. Padded rows are never
// read. Each sum runs from 0 in list order, so a node's b and D are those
// of the plain version's _segment_sum where each group has one row. The
// matvec takes the diagonal part of H p as D_n p_n, the same summed block
// the preconditioner inverts, and adds each valid edge's off-diagonal
// block Hij p_j (node i) or Hij^T p_i (node j); the plain version adds
// Hii p_i, Hjj p_j and Hp p_n row by row. The operator is the same; the
// rounding differs (tests/test_torch_pose_pcg_cuda.py states the
// tolerance), and a step reads 2 x 36 floats an edge and none a prior.
//
// What bounds it on an H100: latency. At the benchmark cell's graph (540
// free nodes, 629 edges) a step is ~0.2 M FLOPs over ~0.3 MB of blocks
// and vectors, ~1 us of one SM's FMA issue and L1 bandwidth, but three
// dependent reductions over every node, and up to 100 steps run back to
// back. The design: one block of 1024 threads on one SM. A block barrier
// costs tens of ns, a thread-block cluster barrier ~0.6 us and a
// cooperative grid barrier ~1 us on this card (ndt_newton, PERF.md), and a
// step needs three, so spreading a step's work over more SMs would cost
// more in barriers than it saves. The free nodes are compacted first (a
// block scan), each (node, row) pair is a thread's item, and every vector,
// block and list the loop reads stays in that SM's L1 or in L2. A step
// measures ~12 us there (PERF.md): the chain of dependent loads a thread's
// three or four items walk between barriers, not the FMAs. A larger graph
// runs the same sums with more items a thread.
//
// Fixed-order sums everywhere, no atomics: each thread adds its items in
// order, a warp by a fixed butterfly, the block's 32 warp sums by warp 0 in
// the same butterfly; so two launches on the same inputs give equal bits.
//
// Build (plain C interface, loaded through ctypes; no torch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpose_pcg.so pose_pcg.cu

#include <cuda_runtime.h>
#include <stdint.h>

// Launch arguments (ctypes mirror: ops/cuda/pose_pcg.py _Args).
struct PosePcgArgs {
  const float* Hii;  // [E, 6, 6]
  const float* Hjj;  // [E, 6, 6]
  const float* Hij;  // [E, 6, 6]
  const float* bi;   // [E, 6]
  const float* bj;   // [E, 6]
  const float* Hp;   // [P, 6, 6]
  const float* bp;   // [P, 6]
  const int* edge_ij;  // [E, 2]
  const int* order;    // [2E + P] incidence codes: e (as i), E + e (as j), 2E + p (prior)
  const int* offsets;  // [N + 1] each node's range of `order`
  const uint8_t* free_mask;  // [N] valid and not fixed
  const float* lam;          // 0-dim
  float* active_steps;       // 0-dim, or null
  float* x;                  // [N, 6] out
  int* iscratch;             // 4N + 2(2E + P) ints
  float* fscratch;           // 108N floats
  int n, n_edges, n_priors, iters;
  float tol2;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// The block's sum of (a, b), equal in every thread; fixed order.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* warp_buf, float2* result) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_buf[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const float2 v = warp_buf[lane];
    a = v.x;
    b = v.y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) *result = make_float2(a, b);
  }
  __syncthreads();
  return *result;
}

// torch.clamp(v, min=lo): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// Dinv = (M + shift I)^-1 for one 6x6 block M (row-major), through the
// Cholesky factor of its lower triangle: exactly symmetric. A block that
// is not positive definite gives NaN, as a failed inverse makes the plain
// version's step non-finite, which the LM loop rejects.
__device__ void spd_inverse6(const float* M, float shift, float* out) {
  float L[21];  // lower triangle, row-major packed: (i, j) at i (i + 1) / 2 + j
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i * (i + 1) / 2 + j] = M[i * 6 + j] + (i == j ? shift : 0.0f);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = L[j * (j + 1) / 2 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
    d = sqrtf(d);
    L[j * (j + 1) / 2 + j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = L[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = v / d;
    }
  }
  float W[21];  // L^-1, lower
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float inv = 1.0f / L[i * (i + 1) / 2 + i];
    W[i * (i + 1) / 2 + i] = inv;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = j; k < i; ++k) s += L[i * (i + 1) / 2 + k] * W[k * (k + 1) / 2 + j];
      W[i * (i + 1) / 2 + j] = -s * inv;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = i; k < 6; ++k) s += W[k * (k + 1) / 2 + i] * W[k * (k + 1) / 2 + j];
      out[i * 6 + j] = s;
      out[j * 6 + i] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) pose_pcg_kernel(const PosePcgArgs a) {
  __shared__ float2 warp_buf[kWarps];
  __shared__ float2 result;
  __shared__ int warp_tot[kWarps];
  __shared__ int n_free;

  const int tid = threadIdx.x;
  const int n = a.n, ne = a.n_edges;
  // scratch
  int* slot_of = a.iscratch;    // [N] node -> slot, -1 if not free
  int* node_of = slot_of + n;   // [N] slot -> node
  int* beg = node_of + n;       // [N] a slot's first list entry
  int* eend = beg + n;          // [N] past its last edge entry (its priors follow)
  int2* ent = reinterpret_cast<int2*>(eend + n);  // [2E + P] (2 e + as_j, other node's slot or -1)
  float* D = a.fscratch;        // [N, 36]
  float* Dinv = D + 36 * n;     // [N, 36]
  float* rbuf = Dinv + 36 * n;  // [2, N, 6]: r, double-buffered by the step's parity
  float* p = rbuf + 12 * n;     // [N, 6]
  float* z = p + 6 * n;         // [N, 6]
  float* Ap = z + 6 * n;        // [N, 6]
  float* xs = Ap + 6 * n;       // [N, 6] x by slot

  // 1. Compact the free nodes in node order: slot s holds the s-th free
  //    node. Each thread takes a run of nodes; a block scan of the runs'
  //    counts gives each run's first slot. x is zeroed on every node.
  {
    const int chunk = (n + kThreads - 1) / kThreads;
    const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
    int cnt = 0;
    for (int v = lo; v < hi; ++v) cnt += __ldg(a.free_mask + v) != 0;
    const int lane = tid & 31, warp = tid >> 5;
    int inc = cnt;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int w = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      warp_tot[lane] = w;  // inclusive over the warps
      if (lane == 31) n_free = w;
    }
    __syncthreads();
    int s = (warp > 0 ? warp_tot[warp - 1] : 0) + inc - cnt;
    for (int v = lo; v < hi; ++v) {
      if (__ldg(a.free_mask + v) != 0) {
        slot_of[v] = s;
        node_of[s] = v;
        ++s;
      } else {
        slot_of[v] = -1;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) a.x[6 * v + c] = 0.0f;
    }
  }
  __syncthreads();
  const int nf = n_free;
  const int items = 6 * nf;  // (slot, row) pairs
  const float lam = *a.lam;

  // 2. Node sums: row k of D and b_k for each free node, from 0 in list
  //    order; the row-0 thread of a node also writes its list's entries
  //    for the loop.
  for (int t = tid; t < items; t += kThreads) {
    const int s = t / 6, k = t - 6 * s;
    const int v = node_of[s];
    const int p0 = __ldg(a.offsets + v), p1 = __ldg(a.offsets + v + 1);
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float bacc = 0.0f;
    int edges_end = p0;
    for (int q = p0; q < p1; ++q) {
      const int code = __ldg(a.order + q);
      const float* blk;
      float bv;
      int other = -1, tag = -1;
      if (code < ne) {
        blk = a.Hii + 36 * static_cast<size_t>(code);
        bv = __ldg(a.bi + 6 * static_cast<size_t>(code) + k);
        other = __ldg(a.edge_ij + 2 * code + 1);
        tag = 2 * code;
        edges_end = q + 1;
      } else if (code < 2 * ne) {
        const int e = code - ne;
        blk = a.Hjj + 36 * static_cast<size_t>(e);
        bv = __ldg(a.bj + 6 * static_cast<size_t>(e) + k);
        other = __ldg(a.edge_ij + 2 * e);
        tag = 2 * e + 1;
        edges_end = q + 1;
      } else {
        const int pr = code - 2 * ne;
        blk = a.Hp + 36 * static_cast<size_t>(pr);
        bv = __ldg(a.bp + 6 * static_cast<size_t>(pr) + k);
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] += __ldg(blk + 6 * k + c);
      bacc += bv;
      if (k == 0) ent[q] = make_int2(tag, other >= 0 ? slot_of[other] : -1);
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) D[36 * s + 6 * k + c] = acc[c];
    rbuf[6 * s + k] = bacc;  // r = b (b on a free node is b * free)
    xs[6 * s + k] = 0.0f;
    if (k == 0) {
      beg[s] = p0;
      eend[s] = edges_end;
    }
  }
  __syncthreads();

  // 3. The preconditioner, a thread a node.
  const float shift = lam + 1e-8f;
  for (int s = tid; s < nf; s += kThreads) spd_inverse6(D + 36 * s, shift, Dinv + 36 * s);
  __syncthreads();

  // 4. p = z = Dinv r; r.z and |r|^2 (= |b|^2).
  float rz, rr, b2;
  {
    float prz = 0.0f, prr = 0.0f;
    for (int t = tid; t < items; t += kThreads) {
      const int s = t / 6, k = t - 6 * s;
      const float* r = rbuf + 6 * s;
      const float* di = Dinv + 36 * s + 6 * k;
      float zk = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) zk += di[c] * r[c];
      p[t] = zk;
      prz += r[k] * zk;
      prr += r[k] * r[k];
    }
    const float2 sums = block_sum2(prz, prr, warp_buf, &result);
    rz = sums.x;
    rr = sums.y;
    b2 = clamp_min(rr, 1e-30f);
  }

  // 5. The steps, while the relative residual is above tol.
  int steps = 0, cur = 0;
  for (int it = 0; it < a.iters; ++it) {
    if (!(rr / b2 > a.tol2)) break;  // the same in every thread
    ++steps;
    // Ap = (H + lam I) p and p.Ap
    float pap = 0.0f;
    for (int t = tid; t < items; t += kThreads) {
      const int s = t / 6, k = t - 6 * s;
      const float* ps = p + 6 * s;
      const float* dk = D + 36 * s + 6 * k;
      float y = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) y += dk[c] * ps[c];
      const int q1 = eend[s];
      for (int q = beg[s]; q < q1; ++q) {
        const int2 en = ent[q];
        if (en.y < 0) continue;  // the other node is fixed: its p is 0
        const float* po = p + 6 * en.y;
        const float* h = a.Hij + 36 * static_cast<size_t>(en.x >> 1);
        float u = 0.0f;
        if (en.x & 1) {  // node j: row k of Hij^T
#pragma unroll
          for (int c = 0; c < 6; ++c) u += __ldg(h + 6 * c + k) * po[c];
        } else {  // node i: row k of Hij
#pragma unroll
          for (int c = 0; c < 6; ++c) u += __ldg(h + 6 * k + c) * po[c];
        }
        y += u;
      }
      const float ap = y + lam * ps[k];
      Ap[t] = ap;
      pap += ps[k] * ap;
    }
    const float alpha = rz / clamp_min(block_sum2(pap, 0.0f, warp_buf, &result).x, 1e-30f);
    // x += alpha p, r -= alpha Ap, z = Dinv r; r.z and |r|^2
    const float* r_old = rbuf + 6 * n * cur;
    float* r_new = rbuf + 6 * n * (cur ^ 1);
    float prz = 0.0f, prr = 0.0f;
    for (int t = tid; t < items; t += kThreads) {
      const int s = t / 6, k = t - 6 * s;
      float rn[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) rn[c] = r_old[6 * s + c] - alpha * Ap[6 * s + c];
      const float* di = Dinv + 36 * s + 6 * k;
      float zk = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) zk += di[c] * rn[c];
      xs[t] += alpha * p[t];
      r_new[t] = rn[k];
      z[t] = zk;
      prz += rn[k] * zk;
      prr += rn[k] * rn[k];
    }
    const float2 sums = block_sum2(prz, prr, warp_buf, &result);
    const float beta = sums.x / clamp_min(rz, 1e-30f);
    rz = sums.x;
    rr = sums.y;
    cur ^= 1;
    for (int t = tid; t < items; t += kThreads) p[t] = z[t] + beta * p[t];
    __syncthreads();  // every p written before the next step reads its neighbours'
  }

  // 6. x by node; the steps that worked.
  for (int t = tid; t < items; t += kThreads) {
    const int s = t / 6, k = t - 6 * s;
    a.x[6 * node_of[s] + k] = xs[t];
  }
  if (tid == 0 && a.active_steps != nullptr) *a.active_steps += static_cast<float>(steps);
}

}  // namespace

extern "C" {

// Launches the solve on `stream` as one block of 1024 threads. The
// scratch is uninitialised device memory of the sizes PosePcgArgs names. Returns
// cudaGetLastError() (0 = ok).
int pose_pcg_launch(const PosePcgArgs* args, void* stream) {
  pose_pcg_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
