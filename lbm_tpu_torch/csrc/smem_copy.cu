// The shared-memory tier's rate: a copy of a block's shared buffer onto
// itself, pass after pass, for the tier bound of K11 (cluster.cu), whose
// state stays in shared memory for a whole chunk.  Not a kernel of the
// solver: only tools/kernel_times.py launches it.
//
// One launch of as many blocks as the card holds at once, each with n4
// 16-byte words of dynamic shared memory; each thread reads and writes the
// same words (kThreads apart) in every pass, four in flight, and a block
// barrier ends each pass, as a tile ends in K11.  The rate is
// 2 x 16 x n4 x passes x blocks over the launch's time.

#include "lbm_common.cuh"

namespace {

constexpr int kUnroll = 4;

__global__ void __launch_bounds__(lbm::kThreads)
    lbm_smem_copy_kernel(float* out, int n4, int passes) {
  extern __shared__ float4 buf[];
  for (int i = threadIdx.x; i < n4; i += lbm::kThreads) {
    buf[i] = make_float4(static_cast<float>(i), 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    for (int i = threadIdx.x; i < n4; i += kUnroll * lbm::kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * lbm::kThreads;
        if (j < n4) v[u] = buf[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * lbm::kThreads;
        if (j < n4) {
          v[u].x = v[u].x + 1.0f;
          buf[j] = v[u];
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < n4) out[blockIdx.x * lbm::kThreads + threadIdx.x] = buf[threadIdx.x].x;
}

}  // namespace

extern "C" {

// Blocks of one copy launch with n4 16-byte words of shared memory each: as
// many as the device holds at once.  Returns <= 0 on error.
int lbm_smem_copy_grid(int n4, int device) {
  int per_sm = 0, sms = 0;
  const size_t smem = static_cast<size_t>(n4) * 16;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaFuncSetAttribute(lbm_smem_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_smem_copy_kernel,
                                                    lbm::kThreads, smem) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// `passes` passes over n4 16-byte words of shared memory in each of `grid`
// blocks (from lbm_smem_copy_grid); out receives grid x kThreads floats.
// Returns the launch's error code, or cudaGetLastError().
int lbm_smem_copy(float* out, int n4, int passes, int grid, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n4 < 1 || passes < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  lbm_smem_copy_kernel<<<grid, lbm::kThreads, static_cast<size_t>(n4) * 16,
                         static_cast<cudaStream_t>(stream)>>>(out, n4, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
