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
//
// K2-batch: K2 over B instances of one periodic grid in one cooperative
// launch, the ensemble's kernel where the B two-copy states fit the L2
// budget (ops/ensemble_cuda.py).  It replaces no TPU kernel: lbm_tpu's
// ensemble runs the jnp step under jax.vmap (lbm_tpu/tools/ensemble.py
// ::_step_traced :47, vmap :117).  Instance b is run by its own group of G
// consecutive blocks (two::Group), with K2's own band plan of G blocks
// (resident_cuda.grid_plan(ny, nx, G)), its own step counters, plan and
// sums in its own slice of the partials, and its state's base pointers
// offset per instance, so K2's 32-bit cell offsets stay per instance and
// every wait (taken cyclically modulo G from the group's base) stays
// inside the instance: a cell in row 0 of instance b waits on, and pulls
// from, row ny - 1 of instance b.  omega, w1 and w2 come from a device
// array into the block's StepParams; the cell update is K2's.  B x G must
// not exceed the blocks that can be resident at once.  Bound: as K2, B
// times over.

#include "two_copy.cuh"

namespace {

__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_resident_kernel(float* fa, float* fb, const uint8_t* __restrict__ obst, float* partials,
                        float* tot_out, lbm::StepParams p, int chunk) {
  const int arow = p.accel_row >= 0 && p.accel_row < p.ny ? p.accel_row * p.nx : -1;
  lbm::two::run(fa, fb, obst, partials, tot_out, p, lbm::two::Periodic{p.ny, arow}, p.ny,
                chunk);
}

__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_resident_batch_kernel(float* fa, float* fb, const uint8_t* __restrict__ obst,
                              long long mask_stride, const float* __restrict__ scalars,
                              float* partials, long long partial_words, float* tot_out,
                              lbm::StepParams p, int chunk, int G, int nb) {
  const int b = static_cast<int>(blockIdx.x) / G;
  p.omega = __ldg(scalars + 3 * b);
  p.w1 = __ldg(scalars + 3 * b + 1);
  p.w2 = __ldg(scalars + 3 * b + 2);
  const size_t state = static_cast<size_t>(b) * 9 * p.ny * p.nx;
  const int arow = p.accel_row >= 0 && p.accel_row < p.ny ? p.accel_row * p.nx : -1;
  lbm::two::run(fa + state, fb + state, obst + b * mask_stride, partials + b * partial_words,
                tot_out + b, p, lbm::two::Periodic{p.ny, arow}, p.ny, chunk,
                lbm::two::Group{static_cast<int>(blockIdx.x) - b * G, G, nb});
}

}  // namespace

extern "C" {

// Blocks of K2-batch that can be resident on the device at once: a batch
// of nb instances may take G blocks each where nb x G does not exceed it.
// Returns <= 0 on error.
int lbm_resident_batch_blocks(int device) {
  return lbm::two::resident_blocks(lbm_resident_batch_kernel, device);
}

// K2-batch: `chunk` steps of nb instances of an ny x nx float32 grid in one
// cooperative launch of nb x G blocks, G per instance.  Instance b's state
// starts at b * 9 * ny * nx of fa and ends there in fb for odd chunk, in
// fa for even; its mask at b * mask_stride bytes of obst (0: one mask for
// all); its omega, w1, w2 at scalars[3b .. 3b + 2] (device memory); its
// slice of partials at b * partial_words words, laid out as K2's for a grid
// of G blocks (counters zero before a runner's first launch, the plan of
// resident_cuda.grid_plan(ny, nx, G), chunk x G sums).  tot_out receives
// chunk x nb sums, step-major.  9 x ny x nx must stay below 2^31 (32-bit
// offsets per instance).  Returns the launch's error code, or
// cudaGetLastError().
int lbm_resident_batch_chunk(float* fa, float* fb, const uint8_t* obst, long long mask_stride,
                             const float* scalars, float* partials, long long partial_words,
                             float* tot_out, int ny, int nx, int accel_row, int chunk, int G,
                             int nb, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cells = static_cast<long long>(ny) * nx;
  if (chunk < 1 || G < 1 || nb < 1 || cells < G || 9 * cells >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, 0.0f, 0.0f, 0.0f};
  void* args[] = {&fa,      &fb, &obst, &mask_stride, &scalars, &partials, &partial_words,
                  &tot_out, &p,  &chunk, &G,         &nb};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_resident_batch_kernel),
                                    dim3(nb * G), dim3(lbm::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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
