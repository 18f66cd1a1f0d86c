// NDT voxel-stat gather by key, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/ndt_reduce.py::gather_stats_onehot (body _gather_kernel)
// used by the NDT derivative evaluation under NDTConfig.gather = "onehot".
// It computes what that kernel computes, onehot(vids == keys) @ table: for
// every query voxel id, the sum of the 16-float table rows whose key equals
// it, added in ascending row order, and a zero row where none does
// (padding ids such as -2 match no key).
//
// What was dropped: the TPU builds the one-hot row by a VPU compare against
// all C keys and contracts it on the MXU, because Mosaic has no VMEM gather
// (C compares and a C x 16 product per id). Here each id is looked up in
// keys that ascend in UNSIGNED order (-1 = 0xFFFFFFFF sorts last). An NDT
// map's keys are built so (NDTMap's invariant: rising voxel ids, then the
// -1 tail, row j holding key j), so a call on map keys is this one launch
// with no sort and no permutation (`perm` null). Other keys are sorted
// stably by the wrapper and their rows read through `perm`, so equal keys
// keep their row order.
//
// What bounds it on an H100: bytes, at the bound: each id's 64 B output
// row (N * S = 32 768 x 7 or 27 ids an evaluation, 15-57 MB). In practice
// the dependent reads before each row and the L2 sectors they touch: a
// binary search of the 256 KB key array per id is a chain of ~17 reads,
// the last ones in L2. So:
//  - a fence, every 16th key, is searched in place: its upper levels are a
//    few lines that every id reads, L1-resident, so only its last levels
//    and the key segment reach L2 (a copy of the fence in shared memory,
//    staged by each block, cost more L2 sectors than the ids, rows and
//    output together, and was slower than a plain binary search: PERF.md);
//  - two lanes serve an id: each reads two uint4 of its 16-key segment, all
//    four loads at once, and the pair counts the keys below and equal to
//    the id with one shuffle. A run of equal keys that reaches the
//    segment's end is walked on while the next fence entry equals the id,
//    so duplicates stay exact;
//  - each lane loads and stores two float4 of the row, so the pairs of a
//    warp store 16 consecutive rows as 1 KB of contiguous bytes.
// 1, 4 or 8 lanes an id, one or four loads a lane, fences of 8 or 32 keys
// and a thread an id searching the whole array were slower on the card.
// Measured numbers are in PERF.md.
//
// Build (plain C interface, loaded through ctypes; no torch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libndt_gather.so ndt_gather.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 2;                    // lanes an id
constexpr int kLoads = 2;                    // uint4 of keys a lane reads a round
constexpr int kRound = 4 * kLanes * kLoads;  // keys a round
constexpr int kStride = kRound;              // keys a fence segment

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads)
    ndt_gather_kernel(const unsigned* __restrict__ keys, const int* __restrict__ perm, int n_keys,
                      const float4* __restrict__ table, const int* __restrict__ vids, int n_ids,
                      float4* __restrict__ out) {
  const int id = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  if (id >= n_ids) return;  // both lanes of the pair
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const unsigned pair_mask = 3u << (lane - sub);
  const int n_fence = (n_keys + kStride - 1) / kStride;
  const unsigned v = static_cast<unsigned>(__ldg(vids + id));
  int lo = 0, hi = n_fence;  // lo: fence entries below v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + static_cast<size_t>(mid) * kStride) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // v's run starts in segment lo - 1, or at fence entry lo
  int pos = (lo > 0 ? lo - 1 : 0) * kStride;
  int first = -1, run = 0;
  for (;;) {
    unsigned k[4 * kLoads];
    int valid[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {  // all loads issued before any is used
      const int base = pos + 4 * (sub + kLanes * r);
      valid[r] = 4;
      if (base + 4 <= n_keys) {
        const uint4 k4 = __ldg(reinterpret_cast<const uint4*>(keys + base));
        k[4 * r] = k4.x, k[4 * r + 1] = k4.y, k[4 * r + 2] = k4.z, k[4 * r + 3] = k4.w;
      } else {
        valid[r] = n_keys - base;
#pragma unroll
        for (int c = 0; c < 4; ++c) k[4 * r + c] = c < valid[r] ? __ldg(keys + base + c) : 0u;
      }
    }
    int count = 0;  // keys below v | keys equal to v << 16, over the pair
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < valid[r]) count += k[4 * r + c] < v ? 1 : (k[4 * r + c] == v ? 1 << 16 : 0);
      }
    }
    count += __shfl_xor_sync(pair_mask, count, 1);
    const int n_less = count & 0xffff, n_equal = count >> 16;
    if (first < 0 && n_less < kRound) first = pos + n_less;
    run += n_equal;
    pos += kRound;
    // v's run (or the place it would start) ends in this round, at the last
    // key, or at a fence entry other than v
    if (n_less + n_equal < kRound || pos >= n_keys || __ldg(keys + pos) != v) break;
  }
  // this lane's float4s of the sum of the rows at sorted positions [first,
  // first + run), in ascending position order (0 + r0 + r1 ..., as the
  // one-hot product adds them for unique keys)
  float4 s[4 / kLanes];
#pragma unroll
  for (int h = 0; h < 4 / kLanes; ++h) s[h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < run; ++j) {
    const int row = perm != nullptr ? __ldg(perm + first + j) : first + j;
#pragma unroll
    for (int h = 0; h < 4 / kLanes; ++h) {
      s[h] = add4(s[h], __ldg(table + 4 * static_cast<size_t>(row) + sub + kLanes * h));
    }
  }
#pragma unroll
  for (int h = 0; h < 4 / kLanes; ++h) out[4 * static_cast<size_t>(id) + sub + kLanes * h] = s[h];
}

}  // namespace

extern "C" {

// Launches the gather on `stream`: `keys` [n_keys] int32 ascending in
// unsigned order (16-byte aligned); `perm` [n_keys] int32 the table row of
// each sorted key, or null when row j holds keys[j]; `table` [n_keys, 16]
// float32 (16-byte aligned); `vids` [n_ids] int32; `out` [n_ids, 16]
// float32. Returns cudaGetLastError() (0 = ok).
int ndt_gather_launch(const int* keys, const int* perm, int n_keys, const float* table, const int* vids,
                      int n_ids, float* out, void* stream) {
  if (n_ids <= 0) return 0;
  // no shared memory: all of it to L1, which holds the fence's upper levels
  static const cudaError_t carveout =
      cudaFuncSetAttribute(ndt_gather_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  const long long threads = static_cast<long long>(n_ids) * kLanes;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  ndt_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const unsigned*>(keys), perm, n_keys, reinterpret_cast<const float4*>(table), vids, n_ids,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
