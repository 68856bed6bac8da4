// K2: the persistent multi-step D2Q9-BGK kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_chunk_kernel
// (:213, f32 path): `chunk` steps in one launch, the state ping-ponging
// between two whole-grid copies that never leave the chip between steps.
//
// Bound: the same 9 x 4 B read + 9 x 4 B written per cell-step as K1, but
// served from L2 instead of device memory where both copies fit (128^2 f32
// state is 576 KiB, 256^2 is 2.25 MiB, against a 50 MB L2), plus one grid
// barrier per step.  On the TPU the two copies sat in VMEM; Hopper has no
// per-core memory that large (227 KB of shared memory per block), so the
// design keeps them in L2 and makes the launch itself persistent: one
// cooperative launch with no more blocks than can be resident at once,
// every block grid-stride looping over the cells, and
// cooperative_groups::this_grid().sync() between steps instead of a kernel
// launch per step.  The wrapper (ops/resident_cuda.py) picks this kernel only
// where 2 x 9 x ny x nx x 4 B fits its L2 budget.
//
// The ping-pong buffers are written and read in the same launch, so they are
// plain pointers: no __restrict__/const, which could let the compiler use the
// non-coherent read-only cache and read a stale value across the barrier.
//
// |u|: per step, each block reduces its cells in a fixed order into
// partials[step][block]; after the last step, one more barrier, and block b
// sums rows b, b + grid, ... in a fixed order into tot_out.  No float atomics.

#include <cooperative_groups.h>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(lbm::kThreads)
    lbm_resident_kernel(float* fa, float* fb, const uint8_t* obst, float* partials,
                        float* tot_out, lbm::StepParams p, int chunk) {
  __shared__ float sh[lbm::kThreads];
  cg::grid_group grid = cg::this_grid();
  const int ncell = p.ny * p.nx;
  const size_t plane = static_cast<size_t>(ncell);
  const int stride = gridDim.x * lbm::kThreads;
  for (int t = 0; t < chunk; ++t) {
    const float* src = (t % 2 == 0) ? fa : fb;
    float* dst = (t % 2 == 0) ? fb : fa;
    float acc = 0.0f;
    for (int c = blockIdx.x * lbm::kThreads + threadIdx.x; c < ncell; c += stride) {
      const int j = c / p.nx;
      const int i = c - j * p.nx;
      float tv[9], out[9];
      lbm::lbm_pull<true>(src, obst, j, i, p, tv);
      acc = acc + lbm::lbm_collide(tv, obst[c] != 0, p.omega, out);
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[k * plane + c] = out[k];
    }
    const float total = lbm::lbm_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = total;
    grid.sync();
  }
  for (int t = blockIdx.x; t < chunk; t += gridDim.x) {
    lbm::lbm_reduce_row(partials, gridDim.x, t, tot_out, sh);
  }
}

}  // namespace

extern "C" {

// Blocks of one cooperative launch over ny x nx cells: no more than one per
// kThreads cells, and no more than can be resident on the device at once
// (a larger cooperative launch is refused).  Returns <= 0 on error.
int lbm_resident_grid(int ny, int nx, int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_resident_kernel,
                                                    lbm::kThreads, 0) != cudaSuccess)
    return -1;
  const long long want = (static_cast<long long>(ny) * nx + lbm::kThreads - 1) / lbm::kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

// Run `chunk` steps in one cooperative launch of `grid` blocks (from
// lbm_resident_grid).  The state starts in fa and ends in fb for odd chunk,
// in fa for even.  partials holds chunk x grid floats; tot_out receives
// chunk per-step sums.  Returns the launch's error code, or
// cudaGetLastError().
int lbm_resident_chunk(float* fa, float* fb, const uint8_t* obst, float* partials,
                       float* tot_out, int ny, int nx, int accel_row, float omega,
                       float w1, float w2, int chunk, int grid, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  void* args[] = {&fa, &fb, &obst, &partials, &tot_out, &p, &chunk};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_resident_kernel),
                                    dim3(grid), dim3(lbm::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
