// K2: the persistent multi-step D2Q9-BGK kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_chunk_kernel
// (:213, f32 path): `chunk` steps in one launch, the state ping-ponging
// between two whole-grid copies that never leave the chip between steps.
//
// Bound: the same 9 x 4 B read + 9 x 4 B written per cell-step as K1, but
// served from L2 instead of device memory where both copies fit (128^2 f32
// state is 576 KiB, 256^2 is 2.25 MiB, against a 50 MB L2), plus each
// step's wait for the neighbouring blocks.  On the TPU the two copies sat
// in VMEM; Hopper has no per-core memory that large (227 KB of shared
// memory per block), so the design keeps them in L2 and makes the launch
// itself persistent: one cooperative launch with no more blocks than can
// be resident at once, each block taking an even share of every step's
// cells and waiting only for the blocks within one row of them before its
// next step (two_copy.cuh, on K3's band plan and step counters).  The
// wrapper (ops/resident_cuda.py) picks this kernel only where
// 2 x 9 x ny x nx x 4 B fits its L2 budget.

#include "two_copy.cuh"

namespace {

__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_resident_kernel(float* fa, float* fb, const uint8_t* __restrict__ obst, float* partials,
                        float* tot_out, lbm::StepParams p, int chunk) {
  const int arow = p.accel_row >= 0 && p.accel_row < p.ny ? p.accel_row * p.nx : -1;
  lbm::two::run(fa, fb, obst, partials, tot_out, p, lbm::two::Periodic{p.ny, arow}, p.ny,
                chunk);
}

}  // namespace

extern "C" {

// Blocks of one cooperative K2 launch over ny x nx cells: no more than one
// per kThreads cells, and no more than can be resident on the device at
// once.  Returns <= 0 on error.
int lbm_resident_grid(int ny, int nx, int device) {
  return lbm::two::grid_blocks(lbm_resident_kernel, static_cast<long long>(ny) * nx, device);
}

// Run `chunk` steps in one cooperative launch of `grid` blocks (from
// lbm_resident_grid).  The state starts in fa and ends in fb for odd chunk,
// in fa for even.  partials holds, in 32-bit words, grid step counters 32
// words apart (zero before a runner's first launch; the kernel keeps them
// equal between launches), the band plan of this grid (grid x 4 int32:
// ops/resident_cuda.py grid_plan) and chunk x grid floats;
// tot_out receives chunk per-step sums.  9 x ny x nx must stay below 2^31
// (32-bit offsets).  Returns the launch's error code, or
// cudaGetLastError().
int lbm_resident_chunk(float* fa, float* fb, const uint8_t* obst, float* partials,
                       float* tot_out, int ny, int nx, int accel_row, float omega,
                       float w1, float w2, int chunk, int grid, void* stream, int device) {
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  void* args[] = {&fa, &fb, &obst, &partials, &tot_out, &p, &chunk};
  return lbm::two::launch(lbm_resident_kernel, args, static_cast<long long>(ny) * nx, chunk,
                          grid, stream, device);
}

}  // extern "C"
