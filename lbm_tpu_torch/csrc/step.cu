// K1: the one-step fused D2Q9-BGK kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/fused_pallas.py::_step_kernel (:249),
// full-grid periodic form, float32 or int16 storage (K1 and K1-i16, one
// template): one launch advances the whole grid one step (driven-row
// injection, 9-way pull streaming, bounce-back, BGK) and leaves a |u|
// partial per block.  The int16 form dequantizes every load and quantizes
// every store (lbm_common.cuh), B1's i16 codec (fused_pallas.py:288-351).
//
// Bound: device-memory bytes.  Every cell-step reads 9 x 4 B and writes
// 9 x 4 B of state (9 x 2 B each way for int16), plus 1 B of mask, against
// ~160 flops, far below the card's ~20 flop/byte balance point.  The design
// therefore aims at one coalesced pass: a block covers 32 columns x 8 rows,
// each thread one cell, and every pulled row segment of every plane is read
// with consecutive threads on consecutive addresses (the +-1 column shifts
// of streaming only move the segment by one word).  Periodic wrap in both
// axes is index arithmetic, so any nx and ny are accepted (no 128-lane rule)
// and no ghost rows are assembled.  The TPU kernel carried the lower ghost
// row in VMEM between sequential grid steps; here blocks run in parallel and
// each one reads its neighbours' rows straight from device memory (through
// L1/L2).
//
// |u|: each block reduces its cells in a fixed tree into partials[step][block];
// a second kernel reduces each step's row of partials in a fixed order into
// tot_out[step].  No float atomics, so runs are deterministic.

#include "lbm_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = lbm::kThreads / kBlockX;  // 8

template <typename T>
__global__ void __launch_bounds__(lbm::kThreads)
    lbm_step_kernel(const T* __restrict__ fin, T* __restrict__ fout,
                    const uint8_t* __restrict__ obst, float* __restrict__ partials,
                    lbm::StepParams p) {
  __shared__ float sh[lbm::kThreads];
  const int i = blockIdx.x * kBlockX + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  float speed = 0.0f;
  if (i < p.nx && j < p.ny) {
    float t[9], out[9];
    lbm::lbm_pull<false>(fin, obst, j, i, p, t);
    const size_t c = static_cast<size_t>(j) * p.nx + i;
    speed = lbm::lbm_collide(t, obst[c] != 0, p.omega, out);
    const size_t plane = static_cast<size_t>(p.ny) * p.nx;
#pragma unroll
    for (int k = 0; k < 9; ++k) fout[k * plane + c] = lbm::lbm_encode<T>(out[k], k, p);
  }
  const float total = lbm::lbm_block_sum(speed, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

dim3 step_grid(int ny, int nx) {
  return dim3((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
}

template <typename T>
int step_run(T* fa, T* fb, const uint8_t* obst, float* partials, float* tot_out,
             const lbm::StepParams& p, int nsteps, int batch, cudaStream_t s) {
  const dim3 grid = step_grid(p.ny, p.nx);
  const dim3 block(kBlockX, kBlockY);
  const int nblocks = static_cast<int>(grid.x * grid.y);
  int done = 0;  // steps whose tot_u has been reduced
  for (int t = 0; t < nsteps; ++t) {
    const T* src = (t % 2 == 0) ? fa : fb;
    T* dst = (t % 2 == 0) ? fb : fa;
    const int row = t - done;
    lbm_step_kernel<T><<<grid, block, 0, s>>>(
        src, dst, obst, partials + static_cast<size_t>(row) * nblocks, p);
    if (row + 1 == batch || t + 1 == nsteps) {
      lbm::lbm_reduce_kernel<0><<<row + 1, lbm::kThreads, 0, s>>>(partials, nblocks,
                                                                  tot_out + done);
      done = t + 1;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Text of a cudaError_t returned by an entry point.
const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of one step launch: the row length of the partials buffer.
int lbm_step_blocks(int ny, int nx) {
  const dim3 g = step_grid(ny, nx);
  return static_cast<int>(g.x * g.y);
}

// Advance `nsteps` steps, ping-ponging fa -> fb -> fa ...: the state starts
// in fa and ends in fa for even nsteps, in fb for odd.  The state is float32
// for i16 = 0, int16 with the 27 codec constants at `codec` (host memory,
// lbm::Codec order) for i16 = 1.  partials holds `batch` rows of
// lbm_step_blocks() floats; every `batch` steps (and after the last) one
// reduce launch turns the filled rows into tot_out[step].  Launches on
// `stream` and never synchronises.  Returns cudaGetLastError().
int lbm_step_run(void* fa, void* fb, const uint8_t* obst, float* partials,
                 float* tot_out, int ny, int nx, int accel_row, float omega,
                 float w1, float w2, int i16, const float* codec, int nsteps,
                 int batch, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return step_run(static_cast<int16_t*>(fa), static_cast<int16_t*>(fb), obst, partials,
                    tot_out, p, nsteps, batch, s);
  }
  return step_run(static_cast<float*>(fa), static_cast<float*>(fb), obst, partials, tot_out,
                  p, nsteps, batch, s);
}

}  // extern "C"
