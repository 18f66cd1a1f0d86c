// NDT voxel-stat gather by key, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   lidar_slam_tpu/ops/pallas/ndt_reduce.py::gather_stats_onehot (body _gather_kernel)
// used by the NDT derivative evaluation under NDTConfig.gather = "onehot".
// It computes what that kernel computes, onehot(vids == keys) @ table: for
// every query voxel id, the sum of the 16-float table rows whose key equals
// it, and a zero row where none does (padding ids such as -2 match no key).
//
// What was dropped: the TPU builds the one-hot row by a VPU compare against
// all C keys and contracts it on the MXU, because Mosaic has no VMEM gather
// (C compares and a C x 16 product per id). Here the wrapper sorts the keys
// once (a stable sort, so equal keys keep their row order) and each thread
// does a lower-bound binary search for its id (~17 steps for C = 65 537),
// then walks the run of equal keys and sums their rows as four float4 loads
// each. Duplicate keys sum, in ascending row order, as the product does.
//
// What bounds it on an H100: one id per thread, N * S = 32 768 x 7 (or 27)
// ids an evaluation, each a dependent chain of ~17 reads from the 256 KB
// sorted keys (L2/L1 resident) plus one 64 B row and one 64 B store.
// Latency-bound and small; measured numbers are in PERF.md.
//
// Build (plain C interface, loaded through ctypes; no torch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libndt_gather.so ndt_gather.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int* __restrict__ sorted_keys, const int* __restrict__ perm, int n_keys,
                  const float4* __restrict__ table, const int* __restrict__ vids, int n_ids,
                  float4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_ids) return;
  const int v = vids[i];
  int lo = 0, hi = n_keys;  // first position with sorted_keys[pos] >= v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sorted_keys + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), s1 = s0, s2 = s0, s3 = s0;
  for (int j = lo; j < n_keys && __ldg(sorted_keys + j) == v; ++j) {
    const float4* row = table + 4 * static_cast<size_t>(__ldg(perm + j));
    s0 = add4(s0, __ldg(row));
    s1 = add4(s1, __ldg(row + 1));
    s2 = add4(s2, __ldg(row + 2));
    s3 = add4(s3, __ldg(row + 3));
  }
  float4* o = out + 4 * static_cast<size_t>(i);
  o[0] = s0;
  o[1] = s1;
  o[2] = s2;
  o[3] = s3;
}

}  // namespace

extern "C" {

// Launches the gather on `stream`: `sorted_keys` [n_keys] ascending int32,
// `perm` [n_keys] int32 their table rows, `table` [n_keys, 16] float32
// (16-byte aligned), `vids` [n_ids] int32, `out` [n_ids, 16] float32.
// Returns cudaGetLastError() (0 = ok).
int ndt_gather_launch(const int* sorted_keys, const int* perm, int n_keys, const float* table,
                      const int* vids, int n_ids, float* out, void* stream) {
  if (n_ids <= 0) return 0;
  const int blocks = (n_ids + kThreads - 1) / kThreads;
  gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, perm, n_keys, reinterpret_cast<const float4*>(table), vids, n_ids,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
