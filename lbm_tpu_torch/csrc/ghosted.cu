// K6: the ghosted chunk kernel of the chunked mode, for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_ghosted_chunk_kernel
// (:997, entry make_ghosted_chunk_runner :1077), f32: `chunk` steps of one
// shard (n body rows) with its two ghost rows frozen for the chunk, in one
// launch.  The semantics are those of `chunk` K1-slab steps with the same
// ghost rows at every step.
//
// Bound: the same 9 x 4 B read + 9 x 4 B written per cell-step as K1, from
// L2 instead of device memory while both copies of the shard fit, plus each
// step's wait for the neighbouring blocks.  On the TPU the shard sat in
// VMEM for the chunk; here, as in K2 (resident.cu), one cooperative launch
// with no more blocks than can be resident at once keeps the two ping-pong
// copies in the 50 MB L2, each block taking an even share of every step's
// cells and waiting only for the blocks within one row of them before its
// next step (two_copy.cuh).  The wrapper (ops/ghosted_cuda.py) maps a shard
// only where 2 x 9 x n x nx x 4 B fit resident_cuda.L2_STATE_BUDGET.
//
// The launch has no opening barrier: the frozen ghosts' driven-row
// injection is recomputed where it is read (rows 0 and n - 1, through
// lbm_pull_slab), as K1-slab does, instead of once into scratch as B8 does
// (:1028-1037).  Nor a closing copy: the result lands where the step
// parity puts it, in fb after an odd chunk and in fa after an even one
// (B8 always ends in its output buffer, :1063-1074), and the wrapper takes
// it from there.

#include "two_copy.cuh"

namespace {

__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_ghosted_kernel(float* fa, float* fb, const float* glo, long long ps_lo,
                       const float* ghi, long long ps_hi, const uint8_t* __restrict__ obst,
                       float* partials, float* tot_out, lbm::StepParams p, int n,
                       int row_offset, int chunk) {
  const int dr = p.accel_row - row_offset;  // the driven row among the body rows
  const lbm::two::Ghosted rows{glo,        ps_lo, ghi, ps_hi, obst, n,
                               row_offset, dr >= 0 && dr < n ? dr * p.nx : -1};
  lbm::two::run(fa, fb, obst + p.nx, partials, tot_out, p, rows, n, chunk);
}

}  // namespace

extern "C" {

// Blocks of one K6 launch over an n x nx shard: no more than one per
// kThreads cells, and no more than can be resident on the device at once.
// Returns <= 0 on error.
int lbm_ghosted_grid(int n, int nx, int device) {
  return lbm::two::grid_blocks(lbm_ghosted_kernel, static_cast<long long>(n) * nx, device);
}

// Run `chunk` steps of one shard in one cooperative launch of `grid`
// blocks (from lbm_ghosted_grid).  fa holds the n x nx body at entry; the
// result is in fb for an odd chunk and in fa for an even one, the other
// buffer clobbered.  glo / ghi are the frozen ghost rows below / above,
// with plane strides ps_lo / ps_hi (elements); obst the (n + 2, nx)
// obstacle slab; row_offset the global row of body row 0.  partials holds,
// in 32-bit words, grid step counters 32 words apart (zero before a
// launcher's first launch; the kernel keeps them equal between launches),
// the band plan of this grid (grid x 4 int32: ops/ghosted_cuda.py
// shard_plan) and chunk x grid floats; tot_out receives chunk per-step sums.
// 9 x n x nx must stay below 2^31 (32-bit offsets).  Returns the launch's
// error code, or cudaGetLastError().
int lbm_ghosted_chunk(float* fa, float* fb, const float* glo, long long ps_lo, const float* ghi,
                      long long ps_hi, const uint8_t* obst, float* partials, float* tot_out,
                      int n, int nx, int row_offset, int accel_row, float omega, float w1,
                      float w2, int chunk, int grid, void* stream, int device) {
  lbm::StepParams p{n, nx, accel_row, omega, w1, w2};
  void* args[] = {&fa, &fb, &glo, &ps_lo, &ghi, &ps_hi, &obst,
                  &partials, &tot_out, &p, &n, &row_offset, &chunk};
  return lbm::two::launch(lbm_ghosted_kernel, args, static_cast<long long>(n) * nx, chunk, grid,
                          stream, device);
}

}  // extern "C"
