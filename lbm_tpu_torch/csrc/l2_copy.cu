// The L2 tier's rate: a persistent copy of one buffer onto itself, pass
// after pass, for the bounds of the kernels whose state stays in the card's
// 50 MB L2 (K2, K3, K6, K7, K8).  Not a kernel of the solver: only
// tools/kernel_times.py launches it.
//
// One cooperative launch of as many blocks as the card holds at once; each
// thread reads and writes the same 16-byte words in every pass (a fixed
// grid-stride map), four words in flight per thread, through L2 only
// (ld.global.cg / st.global.cg) as the persistent kernels read and write.
// With barrier = 1 a grid barrier ends each pass, as a step ends in K2, K3
// and K8.  The rate is 2 x bytes x passes over the launch's time.

#include <cooperative_groups.h>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnroll = 4;

__global__ void __launch_bounds__(lbm::kThreads)
    lbm_l2_copy_kernel(float4* buf, long long n4, int passes, int barrier) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * lbm::kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * lbm::kThreads + threadIdx.x;
  for (int p = 0; p < passes; ++p) {
    for (long long i = first; i < n4; i += kUnroll * stride) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * stride;
        if (j < n4) v[u] = __ldcg(buf + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * stride;
        if (j < n4) {
          v[u].x = v[u].x + 1.0f;
          __stcg(buf + j, v[u]);
        }
      }
    }
    if (barrier) grid.sync();
  }
}

}  // namespace

extern "C" {

// Blocks of one cooperative copy launch: as many as the device holds at
// once.  Returns <= 0 on error.
int lbm_l2_copy_grid(int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_l2_copy_kernel, lbm::kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// `passes` in-place passes over the n4 16-byte words at buf (16-byte
// aligned) in one cooperative launch of `grid` blocks, with a grid barrier
// after each pass when barrier = 1.  Returns the launch's error code, or
// cudaGetLastError().
int lbm_l2_copy(void* buf, long long n4, int passes, int barrier, int grid, void* stream,
                int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n4 < 1 || passes < 1 || grid < 1 || reinterpret_cast<uintptr_t>(buf) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  float4* b = static_cast<float4*>(buf);
  void* args[] = {&b, &n4, &passes, &barrier};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lbm_l2_copy_kernel), dim3(grid), dim3(lbm::kThreads), args,
      0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
