// K7: the resident sweep of the exact communication-avoiding mode (ca), for
// Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_ca_ext_kernel
// (:1192, entry make_ca_chunk_runner :1241), f32: K exact steps of one
// shard from its ghost-extended slab [K rows below | n body rows | K rows
// above] in one launch; the body after the launch is K synchronous
// exchanged steps, bitwise, and the per-level |u| sums count the body's
// fluid cells only.
//
// Bound: 9 x 4 B read + 9 x 4 B written per cell-step of the extended slab
// (n + 2K rows, less the rows each step leaves out), from L2 while the
// slab's two copies fit there, plus each step's wait for the neighbouring
// blocks.  On the TPU the slab sat in VMEM for the sweep; here, as in K2 and
// K6, one cooperative launch with no more blocks than can be resident at
// once keeps two copies in the 50 MB L2.  The wrapper (ops/ca_cuda.py) maps
// a shard only where 2 x 9 x (n + 2K) x nx x 4 B fit
// resident_cuda.L2_STATE_BUDGET.
//
// Design: the two-copy machinery of K2 and K6 (two_copy.cuh) with the
// extended slab as its row source (two::ExtSlab).  B9 computes every row of
// the slab at every step with a periodic roll inside the slab and lets the
// garbage the roll brings in shrink inward one row per step.  Here step t
// (0-based) computes only the rows that are still exact, [t + 1, n + 2K - t
// - 1): they read rows t .. n + 2K - t, which step t - 1 computed.  So
// nothing wraps in y, and step K - 1 computes exactly the body rows, which
// it writes to the output window.  Step 0 reads the three input windows
// directly (lo | body | hi, each with its own plane stride); steps 1 .. K -
// 2 ping-pong between the two scratch copies.  x wraps by index arithmetic.
// Each step's rows are split evenly over all the blocks afresh by K8's band
// plan (ca_cuda.resident_plan, bands aligned to 32 cells), two cells a
// thread, and a block's step t + 1 waits only for the blocks of step t
// within one row of its cells: the relation is symmetric even where the two
// steps split their rows differently, so the one wait covers both hazards
// of two copies (tests/test_torch_resident.py).  The earlier design (one
// cell per thread grid-strided, a divide per cell, a 9-level tree sum and a
// grid barrier per step) took 40.68 us a K = 4 launch on the 256x1024 shard
// (PERF.md §6).
//
// The driven row is found by global row, (row_offset - K + e) mod
// ny_global for extended row e, wherever it falls (body, either ghost
// region, or none; every image where the slab is taller than the grid),
// and injected from the source cell's values, as K1-slab does.
//
// |u|: per step each block sums its body cells in a fixed order into its
// partial; after the last step, block b sums rows b, b + grid, ... in a
// fixed order into tot_out.  No float atomics.

#include "two_copy.cuh"

namespace {

__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_ca_resident_kernel(lbm::two::ExtSlab rows, float* sa, float* sb, float* partials,
                           float* tot_out, lbm::StepParams p, int K) {
  lbm::two::run(sa, sb, rows.obst, partials, tot_out, p, rows, p.ny, K);
}

}  // namespace

extern "C" {

// Blocks of one K7 launch over an extended slab of ext x nx cells: no more
// than one per kThreads cells, and no more than can be resident on the
// device at once.  The wrapper caps it further so that every step's band
// plan gives each block at least 32 cells (ca_cuda.resident_grid).
// Returns <= 0 on error.
int lbm_ca_resident_grid(int ext, int nx, int device) {
  return lbm::two::grid_blocks(lbm_ca_resident_kernel, static_cast<long long>(ext) * nx,
                               device);
}

// K7: advance the n body rows of one shard K steps into `out`, from lo (the
// K rows below), body and hi (the K rows above), each with its own plane
// stride in elements and a row stride of nx, in one cooperative launch of
// `grid` blocks.  sa and sb are scratch of 9 x (n + 2K) x nx floats each;
// obst the (n + 2K, nx) extended obstacle slab; row_offset the global row
// of body row 0; ny_global the grid's row count.  partials holds, in 32-bit
// words, grid step counters 32 words apart (zero before a launcher's first
// launch; the kernel keeps them equal between launches), the band plan (K
// x grid x 4 int32: ops/ca_cuda.py resident_plan) and K x grid floats;
// tot_out receives the K per-level sums over the body's fluid cells.
// 9 x (n + 2K) x nx must stay below 2^31 (32-bit offsets).  Returns the
// launch's error code, or cudaGetLastError().
int lbm_ca_resident(const float* lo, long long ps_lo, const float* body, long long ps,
                    const float* hi, long long ps_hi, float* sa, float* sb, const uint8_t* obst,
                    float* out, long long ps_out, float* partials, float* tot_out, int n, int nx,
                    int K, int row_offset, int ny_global, int accel_row, float omega, float w1,
                    float w2, int grid, void* stream, int device) {
  if (K < 1 || n < K || ny_global < n) return static_cast<int>(cudaErrorInvalidValue);
  const int ext = n + 2 * K;
  lbm::StepParams p{ext, nx, accel_row, omega, w1, w2};
  lbm::two::ExtSlab rows{{lo, ps_lo, body, ps, hi, ps_hi, K, n}, obst, out, ps_out, K * nx,
                         (K + n) * nx, {-1, -1, -1}};
  // The driven row's images: extended rows e = (accel_row - row_offset + K) mod
  // ny_global + m ny_global below ext (at most three, as ext <= 3 ny_global).
  if (accel_row >= 0 && accel_row < ny_global) {
    int e = (accel_row - row_offset + K) % ny_global;
    if (e < 0) e += ny_global;
    for (int m = 0; m < 3 && e < ext; ++m, e += ny_global) rows.d[m] = e * nx;
  }
  void* args[] = {&rows, &sa, &sb, &partials, &tot_out, &p, &K};
  return lbm::two::launch(lbm_ca_resident_kernel, args, static_cast<long long>(ext) * nx, K,
                          grid, stream, device);
}

}  // extern "C"
