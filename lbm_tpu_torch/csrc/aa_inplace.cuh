// The AA in-place machinery shared by K3 (inplace.cu), K8 (ca_inplace.cu)
// and K9 (hbm.cu): the layouts' speed maps, the per-round cell work of a
// thread, the band plan and the neighbour-only step synchronisation.  The
// two-copy kernels K2 and K6 (two_copy.cuh) and K9 take its cell walk, band
// plan and step end too, with counters a line apart.
//
// Work map.  Every step's cells are split into one contiguous range per
// block (a band of whole and part rows), evenly, by the host
// (ops/inplace_cuda.py::band_plan): block b takes cells
// [r0 + b * n / G, r0 + (b + 1) * n / G) of the n cells of the step's rows,
// so no step leaves a near-empty round to some blocks (K8's rows shrink
// every step).  A thread takes kCells cells of its block's range per round,
// kThreads apart (each load and store of a warp stays coalesced), issues
// all their loads before the first collide, and walks rows and columns
// with counters (one divide per step, none per cell); offsets are 32-bit
// (9 planes of the state stay below 2^31 elements, checked on the host).
//
// Synchronisation.  AA's dependencies reach one row per step: a neighbour
// step writes into the slots of rows +-1, which those rows read in the step
// before and the step after.  So a block's step t + 1 waits only for the
// blocks whose step-t cells lie within one row of its own step-(t + 1)
// cells (the plan's dep_lo, dep_n): each block publishes its count of
// finished steps (a release store after a CTA barrier), and waits with
// acquire loads on its dependencies' counts.  The cooperative launch keeps
// every block resident, so the spins cannot starve.  The counters run on
// from launch to launch (all equal at a launch's start), so they need no
// reset.
//
// Plan and scratch: the wrappers' "partials" buffer holds, in 32-bit
// words, the plan (steps x G x 4 int32: start, end, dep_lo, dep_n), then
// the G step counters (zero at first use), then the per-step block sums
// (steps of the launch x G floats).

#pragma once

#include "lbm_common.cuh"

namespace lbm {
namespace aa {

// Cells of one thread per round, and the blocks per SM its registers allow
// (measured on the card, PERF.md Findings PR 8).
constexpr int kCells = 2;
constexpr int kMinBlocks = 4;

// Speed numbering as in lbm_common.cuh.
__device__ __forceinline__ constexpr int cx(int k) {
  return (k == 1 || k == 5 || k == 8) ? 1 : ((k == 3 || k == 6 || k == 7) ? -1 : 0);
}
__device__ __forceinline__ constexpr int cy(int k) {
  return (k == 2 || k == 5 || k == 6) ? 1 : ((k == 4 || k == 7 || k == 8) ? -1 : 0);
}
__device__ __forceinline__ constexpr int opp(int k) {
  return k == 0 ? 0 : (k <= 4 ? (k + 1) % 4 + 1 : (k - 3) % 4 + 5);
}

// The guard byte of a driven-row cell from its stored values, decoded.
template <typename T>
__device__ __forceinline__ uint8_t stored_guard(const T q[9], bool fluid, const StepParams& p) {
  return lbm_guard(fluid, lbm_decode(q[3], 3, p), lbm_decode(q[6], 6, p),
                   lbm_decode(q[7], 7, p), p);
}

// A thread's cell of a round: its row and column, and the offsets (row
// times nx) of its row and of the rows it pulls from / pushes to (cy = +1:
// rs, the row below; cy = -1: rn, the row above), with the columns of
// cx = +1 (iw) and cx = -1 (ie), x wrapping.
struct Cell {
  int j, i, rs, rj, rn, iw, ie;
};

__device__ __forceinline__ Cell cell_at(int j, int i, int js, int jn, int nx) {
  return {j, i, js * nx, j * nx, jn * nx, i == 0 ? nx - 1 : i - 1, i + 1 == nx ? 0 : i + 1};
}

// Pull of a "neighbour" step from the Q layout: t[k] = A[opp(k)][x - c_k].
template <typename T>
__device__ __forceinline__ void load_q(const T* a, int plane, const Cell& c, const StepParams& p,
                                       float t[9]) {
  const int row[3] = {c.rs, c.rj, c.rn};  // source row of cy = +1, 0, -1
  const int col[3] = {c.iw, c.i, c.ie};   // source column of cx = +1, 0, -1
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    t[k] = lbm_load<true>(a + (opp(k) * plane + row[1 - cy(k)] + col[1 - cx(k)]), k, p);
  }
}

// Pull of a "local" step from the P layout: t[k] = A[k][x].
template <typename T>
__device__ __forceinline__ void load_p(const T* a, int plane, const Cell& c, const StepParams& p,
                                       float t[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = lbm_load<true>(a + (k * plane + c.rj + c.i), k, p);
}

// The injection of source cells on the driven row (ds: the row below, dj:
// the cell's own row, dn: the row above), from the guard bytes g: a false
// guard adds 0.0f, as K1 and the plain version do.
__device__ __forceinline__ void inject(float t[9], const uint8_t* g, bool ds, bool dj, bool dn,
                                       const Cell& c, const StepParams& p) {
  if (dj) {
    t[1] = t[1] + (__ldcg(g + c.iw) ? p.w1 : 0.0f);
    t[3] = t[3] - (__ldcg(g + c.ie) ? p.w1 : 0.0f);
  }
  if (ds) {
    t[5] = t[5] + (__ldcg(g + c.iw) ? p.w2 : 0.0f);
    t[6] = t[6] - (__ldcg(g + c.ie) ? p.w2 : 0.0f);
  }
  if (dn) {
    t[7] = t[7] - (__ldcg(g + c.ie) ? p.w2 : 0.0f);
    t[8] = t[8] + (__ldcg(g + c.iw) ? p.w2 : 0.0f);
  }
}

// Push of a "neighbour" step into the P layout: A[k][x + c_k] = q[k].
template <typename T>
__device__ __forceinline__ void store_p(T* a, int plane, const Cell& c, const T q[9]) {
  const int row[3] = {c.rn, c.rj, c.rs};  // destination row of cy = +1, 0, -1
  const int col[3] = {c.ie, c.i, c.iw};   // destination column of cx = +1, 0, -1
#pragma unroll
  for (int k = 0; k < 9; ++k) a[k * plane + row[1 - cy(k)] + col[1 - cx(k)]] = q[k];
}

// Push of a "local" step into the Q layout, A[opp(k)][x] = q[k], or into
// the canonical layout, A[k][x] = q[k] (canonical = true).
template <typename T>
__device__ __forceinline__ void store_local(T* a, int plane, int x, const T q[9], bool canonical) {
#pragma unroll
  for (int k = 0; k < 9; ++k) a[(canonical ? k : opp(k)) * plane + x] = q[k];
}

// One block's entry of the band plan (see the note above).
struct Band {
  int start, end, dep_lo, dep_n;
};

__device__ __forceinline__ Band band(const int* plan, int t, int grid, int block) {
  const int* e = plan + 4 * (t * grid + block);
  return {e[0], e[1], e[2], e[3]};
}

__device__ __forceinline__ Band band(const int* plan, int t, int grid) {
  return band(plan, t, grid, static_cast<int>(blockIdx.x));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* f, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(f), "r"(v) : "memory");
}

// Polls of one counter before a wait gives up (seconds of L2 round trips,
// far beyond any step): a fault of the plan or the counters then ends the
// launch with an error instead of hanging the card.
constexpr unsigned kMaxPolls = 1u << 24;

// Wait until the dep_n blocks from dep_lo (cyclically, of `grid`) have each
// counted at least `count` finished steps; then every thread of the block
// may read what they wrote.
__device__ __forceinline__ void band_wait(const unsigned* flags, const Band& b, int grid,
                                          unsigned count) {
  for (int d = threadIdx.x; d < b.dep_n; d += kThreads) {
    int q = b.dep_lo + d;
    q = q >= grid ? q - grid : q;
    for (unsigned polls = 0; static_cast<int>(ld_acquire(flags + q) - count) < 0; ++polls) {
      if (polls == kMaxPolls) __trap();
    }
  }
  __syncthreads();
}

// The end of a block's step: its |u| sum in a fixed order (a butterfly per
// warp, then the warps in order) into *sum_out, then its count of finished
// steps, published after every thread's stores of the step.  `wsum` holds
// kThreads / 32 floats of shared memory.
__device__ __forceinline__ void step_end(float acc, float* wsum, float* sum_out, unsigned* flag,
                                         unsigned count) {
  const float w = lbm_warp_sum(acc);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) s = s + wsum[q];
    *sum_out = s;
    st_release(flag, count);  // orders the block's stores, seen through the barrier
  }
}

}  // namespace aa
}  // namespace lbm
