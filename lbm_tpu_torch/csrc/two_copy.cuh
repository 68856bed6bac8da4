// The two-copy resident machinery shared by K2 (resident.cu: a periodic
// grid), K6 (ghosted.cu: a shard with two frozen ghost rows) and K7
// (ca_resident.cu: a ca shard's ghost-extended slab): `nsteps` steps in one
// cooperative launch, the state ping-ponging between two copies that stay
// in L2, fa -> fb at even steps and fb -> fa at odd ones, so the result is
// in fb after an odd count and in fa after an even one.  The three forms
// differ only in their row source (Periodic, Ghosted, ExtSlab): which rows
// a cell pulls from, where the driven row is, which cells count in |u|,
// whether a step reads other buffers (K6's rows next to a ghost, K7's step
// 0 from the shard's windows) and where the last step writes (K7: the
// output window).
//
// Work map and synchronisation are aa_inplace.cuh's (K3's): every step's
// cells are split evenly over all resident blocks by the host's band plan
// (ops/inplace_cuda.py::band_plan, one entry per block, in bands whose
// inner ends lie on 32-cell lines), the same every step for K2 and K6 and
// one entry per step for K7, whose rows shrink every step (Rows::kPerStep,
// as K8's plan); a thread takes aa::kCells cells a round, kThreads apart,
// with all their loads issued before the first collide, rows and columns
// come from counters (one divide per step, none per cell) and offsets are
// 32-bit (9 planes below 2^31 elements, checked on the host).
// A block's step t + 1 waits only for the blocks whose step-t cells lie
// within one row of its own (wait_blocks on their step counters), not for
// a grid barrier.  That one wait covers both hazards of two copies: step
// t + 1 reads the other copy where the neighbours wrote it at step t (read
// after write), and writes the copy the neighbours read at step t (write
// after read); "within one row" is symmetric, so the blocks a block waits
// for are the blocks that read it, also where two steps split their rows
// differently (tests/test_torch_resident.py checks it on the plans).  Nor
// does the launch end in a grid barrier: only the blocks that sum a step's
// partials wait, for every block's last step counter.
// Each counter has a 128-byte line of its own (kCounterWords): packed 32
// to a line, as K3's are, every block's polls and releases met on a few
// lines and 256^2 ran 20% slower (PERF.md, Findings PR 10).
//
// Driven row: a pulled value from the driven row carries its source cell's
// guarded injection, the guard recomputed from the source cell in the copy
// being read (as K1 does); K6's rows next to a ghost take the slab pull
// (lbm_pull_slab) and K7's step 0 the three-row pull from the windows
// (lbm_pull_3rows), which inject the same way, so nothing is precomputed
// before the first step.
//
// Every state load goes through L2 only (__ldcg): other blocks wrote it in
// the same launch.  No state pointer is __restrict__/const.
//
// |u|: per step each block sums its cells in a fixed order (per thread in
// cell order, per warp a butterfly, the warps in order) into its partial;
// after the last step, block b sums rows b, b + grid, ... in a fixed order
// into tot_out.  No float atomics, so a run repeats bitwise.

#pragma once

#include "aa_inplace.cuh"

namespace lbm {
namespace two {

using aa::Cell;

// 32-bit words per step counter: one 128-byte line each.
constexpr int kCounterWords = 32;

// The blocks that run one state: the launch's whole grid (K2, K6, K7), or
// one instance's group of `size` blocks of a batched launch (K2-batch,
// resident.cu), `block` this block's index in it.  Its counters, plan, sums
// and state are the group's own, so every wait stays inside the group;
// tot_stride is the distance between the state's per-step sums in tot_out.
struct Group {
  int block;
  int size;
  int tot_stride;
};

// Wait until the n blocks from lo (cyclically, of `grid`) have each counted
// at least `count` finished steps (aa::band_wait on counters a line apart);
// then every thread of the block may read what they wrote.
__device__ __forceinline__ void wait_blocks(const unsigned* counters, int lo, int n, int grid,
                                            unsigned count) {
  for (int d = threadIdx.x; d < n; d += kThreads) {
    int q = lo + d;
    q = q >= grid ? q - grid : q;
    const unsigned* c = counters + q * kCounterWords;
    for (unsigned polls = 0; static_cast<int>(aa::ld_acquire(c) - count) < 0; ++polls) {
      if (polls == aa::kMaxPolls) __trap();
    }
  }
  __syncthreads();
}

// The store of a cell's new values into copy d, at its own offset.
__device__ __forceinline__ void store_cell(float* d, int plane, const Cell& c, const float o[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k * plane + c.rj + c.i] = o[k];
}

// A row source of run() gives: kPerStep, whether the band plan holds an
// entry per step (else one, the same every step); kWindows, whether step 0
// pulls every cell through pull_edge() (K7's windows); below(j) / above(j),
// the rows a cell of row j pulls from; edge(j), whether a cell of row j
// pulls through pull_edge() (another buffer) instead of from the copy;
// driven(r), whether the row at offset r (row x nx) of the copies is the
// driven row; counts(c), whether cell c counts in |u|; store(last, d,
// plane, c, o), the store of a cell's new values (last: the launch's last
// step).

// The rows of K2's grid: periodic in y; no row reads a ghost; arow: the
// driven row's offset, or -1.
struct Periodic {
  static constexpr bool kPerStep = false;
  static constexpr bool kWindows = false;
  int ny;
  int arow;
  __device__ __forceinline__ int below(int j) const { return j == 0 ? ny - 1 : j - 1; }
  __device__ __forceinline__ int above(int j) const { return j + 1 == ny ? 0 : j + 1; }
  __device__ __forceinline__ bool edge(int) const { return false; }
  __device__ __forceinline__ void pull_edge(const float*, int, const Cell&, const StepParams&,
                                            float*) const {}
  __device__ __forceinline__ bool driven(int r) const { return r == arow; }
  __device__ __forceinline__ bool counts(const Cell&) const { return true; }
  __device__ __forceinline__ void store(bool, float* d, int plane, const Cell& c,
                                        const float o[9]) const {
    store_cell(d, plane, c, o);
  }
};

// The rows of K6's shard: n body rows, the frozen ghost rows lo (row -1)
// and hi (row n) in their own buffers with their own plane strides, and the
// (n + 2, nx) obstacle slab; rows 0 and n - 1 (the edges) pull from the
// ghosts through lbm_pull_slab.
struct Ghosted {
  static constexpr bool kPerStep = false;
  static constexpr bool kWindows = false;
  const float* lo;
  long long ps_lo;
  const float* hi;
  long long ps_hi;
  const uint8_t* obst;
  int n;
  int row_offset;
  int arow;  // the driven row's offset among the body rows, or -1
  __device__ __forceinline__ int below(int j) const { return j - 1; }
  __device__ __forceinline__ int above(int j) const { return j + 1; }
  __device__ __forceinline__ bool edge(int j) const { return j == 0 || j + 1 == n; }
  __device__ __forceinline__ void pull_edge(const float* a, int plane, const Cell& c,
                                            const StepParams& p, float t[9]) const {
    const Slab<float> s{a, plane, lo, ps_lo, hi, ps_hi};
    lbm_pull_slab<true>(s, n, obst, row_offset, c.j, c.i, p, t);
  }
  __device__ __forceinline__ bool driven(int r) const { return r == arow; }
  __device__ __forceinline__ bool counts(const Cell&) const { return true; }
  __device__ __forceinline__ void store(bool, float* d, int plane, const Cell& c,
                                        const float o[9]) const {
    store_cell(d, plane, c, o);
  }
};

// The rows of K7's ghost-extended slab [K rows below | n body rows | K rows
// above] (ext = n + 2K rows, the copies' rows e = 0 .. ext - 1): step t
// computes rows [t + 1, ext - t - 1), so no row wraps in y; step 0 pulls
// from the three input windows (`in`, each with its own plane stride), the
// last step writes the body rows to the output window (plane stride
// ps_out); |u| counts the body rows.  The driven row is found by global
// row, (row_offset - K + e) mod ny_global: its images in the slab, at most
// three (ext <= 3 ny_global, as n <= ny_global), are the offsets d[0..3),
// -1 where there is none.
struct ExtSlab {
  static constexpr bool kPerStep = true;
  static constexpr bool kWindows = true;
  Ext<float> in;
  const uint8_t* obst;  // the (ext, nx) obstacle slab
  float* out;
  long long ps_out;
  int body_lo, body_hi;  // body rows [K, K + n), as offsets (row x nx)
  int d[3];
  __device__ __forceinline__ int below(int j) const { return j - 1; }
  __device__ __forceinline__ int above(int j) const { return j + 1; }
  __device__ __forceinline__ bool edge(int) const { return false; }
  __device__ __forceinline__ bool driven(int r) const {
    return r == d[0] || r == d[1] || r == d[2];
  }
  __device__ __forceinline__ void pull_edge(const float*, int, const Cell& c,
                                            const StepParams& p, float t[9]) const {
    long long pss, psj, psn;
    const float* rs = lbm_ext_row(in, c.j - 1, p.nx, &pss);
    const float* rj = lbm_ext_row(in, c.j, p.nx, &psj);
    const float* rn = lbm_ext_row(in, c.j + 1, p.nx, &psn);
    const uint8_t* wj = obst + c.rj;
    lbm_pull_3rows<true>(rs, pss, rj, psj, rn, psn, wj - p.nx, wj, wj + p.nx, driven(c.rs),
                         driven(c.rj), driven(c.rn), c.i, p, t);
  }
  __device__ __forceinline__ bool counts(const Cell& c) const {
    return c.rj >= body_lo && c.rj < body_hi;
  }
  __device__ __forceinline__ void store(bool last, float* d_, int plane, const Cell& c,
                                        const float o[9]) const {
    if (last) {
      float* oc = out + (c.rj - body_lo + c.i);
#pragma unroll
      for (int k = 0; k < 9; ++k) oc[k * ps_out] = o[k];
    } else {
      store_cell(d_, plane, c, o);
    }
  }
};

// The pull of streaming from a copy: t[k] = a[k][x - c_k].
__device__ __forceinline__ void load_pull(const float* a, int plane, const Cell& c,
                                          float t[9]) {
  const int row[3] = {c.rs, c.rj, c.rn};  // source row of cy = +1, 0, -1
  const int col[3] = {c.iw, c.i, c.ie};   // source column of cx = +1, 0, -1
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    t[k] = __ldcg(a + (k * plane + row[1 - aa::cy(k)] + col[1 - aa::cx(k)]));
  }
}

// The guarded injection of the source cell at offset x: w, or 0.0f where
// the guard is false.
__device__ __forceinline__ float gate(const float* a, int plane, const uint8_t* wall, int x,
                                      float w, const StepParams& p) {
  return lbm_guard(!wall[x], __ldcg(a + (3 * plane + x)), __ldcg(a + (6 * plane + x)),
                   __ldcg(a + (7 * plane + x)), p)
             ? w
             : 0.0f;
}

// The injection of pulled values from the driven row (rows.driven), in
// lbm_pull()'s order.
template <class Rows>
__device__ __forceinline__ void inject(float t[9], const float* a, int plane,
                                       const uint8_t* wall, const Cell& c, const Rows& rows,
                                       const StepParams& p) {
  if (rows.driven(c.rj)) {
    t[1] = t[1] + gate(a, plane, wall, c.rj + c.iw, p.w1, p);
    t[3] = t[3] - gate(a, plane, wall, c.rj + c.ie, p.w1, p);
  }
  if (rows.driven(c.rs)) {
    t[5] = t[5] + gate(a, plane, wall, c.rs + c.iw, p.w2, p);
    t[6] = t[6] - gate(a, plane, wall, c.rs + c.ie, p.w2, p);
  }
  if (rows.driven(c.rn)) {
    t[7] = t[7] - gate(a, plane, wall, c.rn + c.ie, p.w2, p);
    t[8] = t[8] + gate(a, plane, wall, c.rn + c.iw, p.w2, p);
  }
}

// One step's cells of a block: its band [c_first - threadIdx.x, end), the
// thread's first cell at row j, column i, kThreads cells a move of (dj,
// di); kWindows: every cell pulls through rows.pull_edge() (K7's step 0,
// compiled apart so that the other steps keep their registers).  Returns
// the thread's |u| sum.
template <bool kWindows, class Rows>
__device__ __forceinline__ float step_cells(const float* a, float* d, int plane,
                                            const uint8_t* __restrict__ wall,
                                            const StepParams& p, const Rows& rows, int c_first,
                                            int end, int j, int i, int dj, int di, bool last) {
  constexpr int kC = aa::kCells;
  const int nx = p.nx;
  float acc = 0.0f;
  for (int c0 = c_first; c0 < end; c0 += kC * kThreads) {
    Cell cl[kC];
    bool act[kC];
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      act[m] = c0 + m * kThreads < end;
      cl[m] = aa::cell_at(j, i, rows.below(j), rows.above(j), nx);
      i += di;
      j += dj;
      if (i >= nx) {
        i -= nx;
        ++j;
      }
    }
    float tv[kC][9];
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      if (!act[m]) continue;
      if (kWindows || rows.edge(cl[m].j)) {
        rows.pull_edge(a, plane, cl[m], p, tv[m]);
      } else {
        load_pull(a, plane, cl[m], tv[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      if (!act[m]) continue;
      const Cell& c = cl[m];
      if (!kWindows && !rows.edge(c.j)) inject(tv[m], a, plane, wall, c, rows, p);
      float out[9];
      const float speed = lbm_collide(tv[m], wall[c.rj + c.i] != 0, p.omega, out);
      if (rows.counts(c)) acc = acc + speed;
      rows.store(last, d, plane, c, out);
    }
  }
  return acc;
}

// `nsteps` steps of an nrows x nx state from fa, ping-ponging with fb (see
// the note above), by the blocks of `g`.  wall: the obstacle bytes of the
// state's row 0, rows nx apart; partials, in 32-bit words
// (ops/resident_cuda.py partials_buffer): g.size step counters
// kCounterWords apart, the band plan (g.size x 4 int32, or nsteps x g.size
// x 4 for Rows::kPerStep) and nsteps x g.size sums; step t's sum goes to
// tot_out[t * g.tot_stride].
template <class Rows>
__device__ __forceinline__ void run(float* fa, float* fb, const uint8_t* __restrict__ wall,
                                    float* partials, float* tot_out, const StepParams& p,
                                    const Rows& rows, int nrows, int nsteps, const Group& g) {
  __shared__ float sh[kThreads];
  __shared__ float wsum[kThreads / 32];
  const int nx = p.nx;
  const int plane = nrows * nx;
  const int G = g.size;
  unsigned* counters = reinterpret_cast<unsigned*>(partials);
  unsigned* counter = counters + g.block * kCounterWords;
  const int* plan = reinterpret_cast<const int*>(partials + kCounterWords * G);
  float* sums = partials + (kCounterWords + 4 * (Rows::kPerStep ? nsteps : 1)) * G;
  const unsigned base = __ldcg(counter);
  // The move of kThreads cells, in rows and columns.
  const int dj = kThreads / nx, di = kThreads - dj * nx;
  aa::Band bd = aa::band(plan, 0, G, g.block), next = bd;
  // The thread's first cell of the step, in rows and columns.
  int c_first = bd.start + static_cast<int>(threadIdx.x);
  int j_first = c_first / nx, i_first = c_first - j_first * nx;

  for (int t = 0; t < nsteps; ++t) {
    if constexpr (Rows::kPerStep) {
      if (t > 0) {
        bd = next;
        c_first = bd.start + static_cast<int>(threadIdx.x);
        j_first = c_first / nx;
        i_first = c_first - j_first * nx;
      }
      if (t + 1 < nsteps) next = aa::band(plan, t + 1, G, g.block);  // in flight this step
    }
    const float* a = (t & 1) ? fb : fa;
    float* d = (t & 1) ? fa : fb;
    const bool last = t + 1 == nsteps;
    if (t > 0) wait_blocks(counters, bd.dep_lo, bd.dep_n, G, base + t);
    float acc;
    if constexpr (Rows::kWindows) {
      acc = t == 0 ? step_cells<true>(a, d, plane, wall, p, rows, c_first, bd.end, j_first,
                                      i_first, dj, di, last)
                   : step_cells<false>(a, d, plane, wall, p, rows, c_first, bd.end, j_first,
                                       i_first, dj, di, last);
    } else {
      acc = step_cells<false>(a, d, plane, wall, p, rows, c_first, bd.end, j_first, i_first, dj,
                              di, last);
    }
    aa::step_end(acc, wsum, sums + t * G + g.block, counter, base + t + 1);
  }
  if (g.block < nsteps) {  // it sums a step: wait for every block's last
    wait_blocks(counters, 0, G, G, base + nsteps);
  }
  for (int t = g.block; t < nsteps; t += G) {
    lbm_reduce_row(sums + t * G, G, 0, tot_out + t * g.tot_stride, sh);
  }
}

// run() by the launch's whole grid.
template <class Rows>
__device__ __forceinline__ void run(float* fa, float* fb, const uint8_t* __restrict__ wall,
                                    float* partials, float* tot_out, const StepParams& p,
                                    const Rows& rows, int nrows, int nsteps) {
  run(fa, fb, wall, partials, tot_out, p, rows, nrows, nsteps,
      Group{static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x), 1});
}

// Blocks of one cooperative launch of `kernel` over `cells` cells: no more
// than one per kThreads cells, and no more than can be resident on the
// device at once (a larger cooperative launch is refused).  Returns <= 0
// on error.
template <typename Kernel>
int grid_blocks(Kernel kernel, long long cells, int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
      cudaSuccess)
    return -1;
  const long long want = (cells + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

// Blocks of `kernel` that can be resident on the device at once (the most a
// cooperative launch takes), or <= 0 on error.
template <typename Kernel>
int resident_blocks(Kernel kernel, int device) {
  return grid_blocks(kernel, 1LL << 40, device);
}

// The launch of `kernel` with `args` on `grid` blocks, after the checks its
// entry point shares: at least one step and one block, 9 planes of `cells`
// below 2^31 elements (32-bit offsets).  Returns the launch's error code,
// or cudaGetLastError().
template <typename Kernel>
int launch(Kernel kernel, void** args, long long cells, int nsteps, int grid, void* stream,
           int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsteps < 1 || grid < 1 || cells < grid || 9 * cells >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace two
}  // namespace lbm
