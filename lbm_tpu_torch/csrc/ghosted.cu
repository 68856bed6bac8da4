// K6: the ghosted chunk kernel of the chunked mode, for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_ghosted_chunk_kernel
// (:997, entry make_ghosted_chunk_runner :1077), f32: `chunk` steps of one
// shard (n body rows) with its two ghost rows frozen for the chunk, in one
// launch.  The semantics are those of `chunk` K1-slab steps with the same
// ghost rows at every step.
//
// Bound: the same 9 x 4 B read + 9 x 4 B written per cell-step as K1, from
// L2 instead of device memory while both copies of the shard fit, plus one
// grid barrier per step.  On the TPU the shard sat in VMEM for the chunk;
// here, as in K2 (resident.cu), one cooperative launch with no more blocks
// than can be resident at once keeps the two ping-pong copies in the 50 MB
// L2, every block grid-stride looping over the shard's cells, with
// cooperative_groups::this_grid().sync() between steps.  The wrapper
// (ops/ghosted_cuda.py) maps a shard only where 2 x 9 x n x nx x 4 B fit
// resident_cuda.L2_STATE_BUDGET.
//
// The frozen ghosts' driven-row injection is computed once, at the start of
// the launch, into a scratch copy of the two ghost rows (gscr); the steps
// then read the injected rows from there (lbm_pull_slab<..., false>), as B8
// precomputes it (:1028-1037).  Body rows are injected at every step from
// the source cell, as in K1.
//
// As in B8 (:1063-1074) the result always lands in the output buffer `fb`:
// the steps ping-pong fa -> fb -> fa ..., and an even chunk, which ends in
// fa, copies it to fb after the last barrier.  fa is clobbered.
//
// Buffers written during the launch (fa, fb, gscr, partials) are plain
// pointers read through L2 only (__ldcg in lbm_pull_slab<true, ...>): L1 is
// not coherent with other SMs' writes across the barrier.
//
// |u|: per step, each block reduces its cells in a fixed order into
// partials[step][block]; after the last step, one more barrier, and block b
// sums rows b, b + grid, ... in a fixed order into tot_out.  No float atomics.

#include <cooperative_groups.h>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(lbm::kThreads)
    lbm_ghosted_kernel(float* fa, float* fb, const float* glo, long long ps_lo,
                       const float* ghi, long long ps_hi, float* gscr, const uint8_t* obst,
                       float* partials, float* tot_out, lbm::StepParams p, int n,
                       int row_offset, int chunk) {
  __shared__ float sh[lbm::kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx;
  const int ncell = n * nx;
  const size_t plane = static_cast<size_t>(ncell);
  const int stride = gridDim.x * lbm::kThreads;
  const int first = blockIdx.x * lbm::kThreads + threadIdx.x;

  // The two frozen ghost rows, injected once: gscr holds the lower one at
  // [k * nx + i] and the upper one at [(9 + k) * nx + i].
  for (int c = first; c < 2 * nx; c += stride) {
    const int side = c / nx;
    const int i = c - side * nx;
    const float* g = side ? ghi : glo;
    const long long ps = side ? ps_hi : ps_lo;
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = g[k * ps + i];
    const int row = side ? row_offset + n : row_offset - 1;
    if (row == p.accel_row) {
      const bool ok = lbm::lbm_guard(!obst[static_cast<size_t>(side ? n + 1 : 0) * nx + i],
                                     v[3], v[6], v[7], p);
      const float d1 = ok ? p.w1 : 0.0f;
      const float d2 = ok ? p.w2 : 0.0f;
      v[1] = v[1] + d1;
      v[3] = v[3] - d1;
      v[5] = v[5] + d2;
      v[6] = v[6] - d2;
      v[7] = v[7] - d2;
      v[8] = v[8] + d2;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) gscr[static_cast<size_t>(side * 9 + k) * nx + i] = v[k];
  }
  grid.sync();

  lbm::Slab<float> s{fa, static_cast<long long>(plane), gscr, nx, gscr + 9 * nx, nx};
  for (int t = 0; t < chunk; ++t) {
    s.body = (t % 2 == 0) ? fa : fb;
    float* dst = (t % 2 == 0) ? fb : fa;
    float acc = 0.0f;
    for (int c = first; c < ncell; c += stride) {
      const int j = c / nx;
      const int i = c - j * nx;
      float tv[9], out[9];
      lbm::lbm_pull_slab<true, false>(s, n, obst, row_offset, j, i, p, tv);
      acc = acc + lbm::lbm_collide(tv, obst[static_cast<size_t>(j + 1) * nx + i] != 0,
                                   p.omega, out);
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[k * plane + c] = out[k];
    }
    const float total = lbm::lbm_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = total;
    grid.sync();
  }
  if (chunk % 2 == 0) {
    for (int c = first; c < ncell; c += stride) {
#pragma unroll
      for (int k = 0; k < 9; ++k) fb[k * plane + c] = __ldcg(fa + k * plane + c);
    }
  }
  for (int t = blockIdx.x; t < chunk; t += gridDim.x) {
    lbm::lbm_reduce_row(partials, gridDim.x, t, tot_out, sh);
  }
}

}  // namespace

extern "C" {

// Blocks of one K6 launch over an n x nx shard: no more than one per
// kThreads cells (at least one), and no more than can be resident on the
// device at once.  Returns <= 0 on error.
int lbm_ghosted_grid(int n, int nx, int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_ghosted_kernel,
                                                    lbm::kThreads, 0) != cudaSuccess)
    return -1;
  const long long want = (static_cast<long long>(n) * nx + lbm::kThreads - 1) / lbm::kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

// Run `chunk` steps of one shard in one cooperative launch of `grid`
// blocks (from lbm_ghosted_grid).  fa holds the n x nx body at entry and
// is clobbered; the result is in fb.  glo / ghi are the frozen ghost rows
// below / above, with plane strides ps_lo / ps_hi (elements); gscr is
// scratch of 2 x 9 x nx floats; obst the (n + 2, nx) obstacle slab;
// row_offset the global row of body row 0; partials holds chunk x grid
// floats; tot_out receives chunk per-step sums.  Returns the launch's error
// code, or cudaGetLastError().
int lbm_ghosted_chunk(float* fa, float* fb, const float* glo, long long ps_lo, const float* ghi,
                      long long ps_hi, float* gscr, const uint8_t* obst, float* partials,
                      float* tot_out, int n, int nx, int row_offset, int accel_row, float omega,
                      float w1, float w2, int chunk, int grid, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::StepParams p{n, nx, accel_row, omega, w1, w2};
  void* args[] = {&fa, &fb, &glo, &ps_lo, &ghi, &ps_hi, &gscr, &obst,
                  &partials, &tot_out, &p, &n, &row_offset, &chunk};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_ghosted_kernel),
                                    dim3(grid), dim3(lbm::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
