// Device code shared by the two NDT kernels for NVIDIA Hopper (sm_90a):
// ndt_fused.cu (one derivative evaluation: K1) and ndt_newton.cu (the whole
// clamped-Newton alignment). Both sum the weighted Magnusson NDT score,
// gradient[6] and upper-triangular Hessian[21] over every (source point,
// stencil voxel) pair, gated on a valid voxel, d2*exp in [0, 1] and finite,
// and (radius27 only) |x' - mu|^2 <= res^2.
//
// The unit of work is one (point, stencil offset) pair, not one point: a
// grid-stride loop over pairs keeps all of a cloud's independent index-then-
// row gathers in flight at once, where a thread per point ran its 7 or 27
// gathers one after another. Every thread of a block runs the loop the same
// number of times (the bound test sits inside the loop): when the threads of
// the block holding the pairs' ragged end left the loop after different trip
// counts, that block's reduction ran ~6 us late on an H100, and with it every
// evaluation (PERF.md). Each block reduces its 28 sums in a fixed order
// (warp shuffles, then the warps in order) into one column of a [28, blocks]
// partials table, and the table is summed in a fixed order too, so a rerun
// repeats to the bit.
//
// No --use_fast_math: expf, sinf, cosf, sqrtf and the divisions stay IEEE.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ndt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNAcc = 28;   // score, grad[6], Hessian upper triangle[21]
constexpr int kNCoef = 93;  // pose coefficients: R[9], t[3], J[27], H[54]

// Pose coefficients, in the order of the ctypes mirror in ops/cuda/ndt_fused.py:
//   R[9] rotation (row-major), t[3] translation,
//   J[27]: jrot(r, a) = J[(3r + a) * 3 + j] . x   (x = raw point),
//   H[54]: hrot(pair k, r) = H[(3k + r) * 3 + j] . x, pairs 00 01 02 11 12 22.
constexpr int kR = 0, kT = 9, kJ = 12, kH = 39;

// Constants of one map and one source cloud.
struct GridConsts {
  float origin[3];  // grid min corner (metres)
  float res;        // voxel edge
  float res2;       // radius27 gate, res^2
  float d1;         // Gaussian-mixture constants (Magnusson 2009, eq. 6.8)
  float d2;
  int dims[3];      // grid dims, flat voxel id = (x * dims[1] + y) * dims[2] + z
  int weight_derivatives;  // 1: voxel static weight also scales grad/Hessian
};

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

__device__ __forceinline__ float dot3(const float* c, float x, float y, float z) {
  return c[0] * x + c[1] * y + c[2] * z;
}

// R, t, J[27], H[54] of pose p (tx, ty, tz, roll, pitch, yaw) into c, in
// the layout above: one thread's work. ndt_fused.cu runs it when its caller
// passes the pose on the card (ndt_newton.cu evaluates the same text on a
// warp).
__device__ __noinline__ void pose_coefficients(const float* p, float* c) {
  const float ca = cosf(p[3]), sa = sinf(p[3]);
  const float cb = cosf(p[4]), sb = sinf(p[4]);
  const float cc = cosf(p[5]), sc = sinf(p[5]);
  // the derivative coefficients snap angles below 1e-4 to exactly 0
  const bool snap_x = fabsf(p[3]) < 1e-4f, snap_y = fabsf(p[4]) < 1e-4f, snap_z = fabsf(p[5]) < 1e-4f;
  const float cx = snap_x ? 1.0f : ca, sx = snap_x ? 0.0f : sa;
  const float cy = snap_y ? 1.0f : cb, sy = snap_y ? 0.0f : sb;
  const float cz = snap_z ? 1.0f : cc, sz = snap_z ? 0.0f : sc;
  c[kT + 0] = p[0];
  c[kT + 1] = p[1];
  c[kT + 2] = p[2];
#include "coefficient_terms.cuh"
}

// Adds the terms of the pair (point pt = (x, y, z, weight), stencil offset o)
// to acc. `coef` holds the pose coefficients (shared memory).
template <int NOFF>
__device__ __forceinline__ void accumulate_pair(const float4 pt, const int o,
                                                const int* __restrict__ index,
                                                const float4* __restrict__ packed,
                                                const float* __restrict__ coef,
                                                const GridConsts& g, float (&acc)[kNAcc]) {
  const float x = pt.x, y = pt.y, z = pt.z, pw = pt.w;
  const float* R = coef + kR;
  const float xp0 = R[0] * x + R[1] * y + R[2] * z + coef[kT + 0];
  const float xp1 = R[3] * x + R[4] * y + R[5] * z + coef[kT + 1];
  const float xp2 = R[6] * x + R[7] * y + R[8] * z + coef[kT + 2];

  int ox, oy, oz;
  Stencil<NOFF>::offset(o, ox, oy, oz);
  const int nx = clamp_cell(static_cast<int>(floorf((xp0 - g.origin[0]) / g.res)), g.dims[0]) + ox;
  const int ny = clamp_cell(static_cast<int>(floorf((xp1 - g.origin[1]) / g.res)), g.dims[1]) + oy;
  const int nz = clamp_cell(static_cast<int>(floorf((xp2 - g.origin[2]) / g.res)), g.dims[2]) + oz;
  if (nx < 0 || nx >= g.dims[0] || ny < 0 || ny >= g.dims[1] || nz < 0 || nz >= g.dims[2]) return;
  const int row = __ldg(index + (nx * g.dims[1] + ny) * g.dims[2] + nz);
  // packed row: [0:3] mean, [3] static weight, [4:10] icov upper
  // (xx xy xz yy yz zz), [10] valid, [11] count, [12:16] pad
  const float4 s0 = __ldg(packed + 4 * row);
  const float4 s1 = __ldg(packed + 4 * row + 1);
  const float4 s2 = __ldg(packed + 4 * row + 2);
  if (!(s2.z > 0.5f)) return;

  const float e0 = xp0 - s0.x, e1 = xp1 - s0.y, e2 = xp2 - s0.z;
  if (Stencil<NOFF>::kRadiusGate && !(e0 * e0 + e1 * e1 + e2 * e2 <= g.res2)) return;

  const float ci[3][3] = {{s1.x, s1.y, s1.z}, {s1.y, s1.w, s2.x}, {s1.z, s2.x, s2.y}};
  const float q0 = ci[0][0] * e0 + ci[0][1] * e1 + ci[0][2] * e2;
  const float q1 = ci[1][0] * e0 + ci[1][1] * e1 + ci[1][2] * e2;
  const float q2 = ci[2][0] * e0 + ci[2][1] * e1 + ci[2][2] * e2;
  const float md = q0 * e0 + q1 * e1 + q2 * e2;
  const float expt = expf(-0.5f * g.d2 * md);
  const float exd = g.d2 * expt;
  // updateDerivatives' guard: d2 * exp(...) in [0, 1] and finite
  if (!(exd <= 1.0f && exd >= 0.0f && isfinite(exd))) return;

  const float sv = s0.w;
  acc[0] += sv * pw * (-g.d1) * expt;
  const float f = (g.weight_derivatives ? sv * pw : pw) * g.d1 * g.d2 * expt;

  float jr[3][3];  // jr[r][a]: row r of the rotation Jacobian, angle a
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int a = 0; a < 3; ++a) jr[r][a] = dot3(coef + kJ + (3 * r + a) * 3, x, y, z);

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
      float term = -g.d2 * f * qj[i] * qj[j];
      if (j < 3) {
        term += f * ci[i][j];
      } else if (i < 3) {
        term += f * cj[i][j - 3];
      } else {
        const int a = i - 3, b = j - 3;  // a <= b
        const int k = a * 3 - a * (a - 1) / 2 + (b - a);
        const float* h = coef + kH + 9 * k;
        term += f * (jr[0][a] * cj[0][b] + jr[1][a] * cj[1][b] + jr[2][a] * cj[2][b]);
        term += f * (q0 * dot3(h, x, y, z) + q1 * dot3(h + 3, x, y, z) + q2 * dot3(h + 6, x, y, z));
      }
      acc[7 + u] += term;
    }
}

// The block's 28 sums, each reduced in a fixed order, stored to
// dst[k * stride] (one column of a [28, blocks] table).
__device__ __forceinline__ void block_reduce_store(const float (&acc)[kNAcc],
                                                   float (*warp_sums)[kNAcc], float* dst,
                                                   int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNAcc) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    dst[threadIdx.x * stride] = v;
  }
}

// sums[k] = the [28, n_cols] table's row k summed in a fixed order: warp w
// takes rows w, w + 8, ...; its lanes stride the columns, then a butterfly.
// The loads of a chunk of 512 columns are all issued before the first add,
// so the warp waits about one L2 round trip per chunk, not one per load.
// The table was written by other blocks of the same launch, so it is read
// through L2 (__ldcg), never through the non-coherent L1 path.
__device__ __forceinline__ void sum_partials(const float* table, int n_cols, float* sums) {
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
        const int k = warp + r * kWarps, c = c0 + j * 32 + lane;
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
    const int k = warp + r * kWarps;
    if (lane == 0 && k < kNAcc) sums[k] = v[r];
  }
}

}  // namespace ndt
