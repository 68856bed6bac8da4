// The two-copy resident machinery shared by K2 (resident.cu: a periodic
// grid) and K6 (ghosted.cu: a shard with two frozen ghost rows): `nsteps`
// steps in one cooperative launch, the state ping-ponging between two
// copies that stay in L2, fa -> fb at even steps and fb -> fa at odd ones,
// so the result is in fb after an odd count and in fa after an even one.
// The two forms differ only in their row source (Periodic, Ghosted).
//
// Work map and synchronisation are aa_inplace.cuh's (K3's): every step's
// cells are split evenly over all resident blocks by the host's band plan
// (ops/inplace_cuda.py::band_plan, one entry per block, the same every
// step, in bands that start on 32-cell lines), a thread takes aa::kCells cells a
// round, kThreads apart, with all their loads issued before the first
// collide, rows and columns come from counters (no divide per cell) and
// offsets are 32-bit (9 planes below 2^31 elements, checked on the host).
// A block's step t + 1 waits only for the blocks whose cells lie within
// one row of its own (wait_blocks on their step counters), not for a grid
// barrier.  That one wait covers both hazards of two copies: step t + 1
// reads the other copy where the neighbours wrote it at step t (read after
// write), and writes the copy the neighbours read at step t (write after
// read); "within one row" is symmetric, so the blocks a block waits for
// are the blocks that read it (tests/test_torch_resident.py checks it on
// the plan).  Nor does the launch end in a grid barrier: only the blocks
// that sum a step's partials wait, for every block's last step counter.
// Each counter has a 128-byte line of its own (kCounterWords): packed 32
// to a line, as K3's are, every block's polls and releases met on a few
// lines and 256^2 ran 20% slower (PERF.md, Findings PR 10).
//
// Driven row: a pulled value from the driven row carries its source cell's
// guarded injection, the guard recomputed from the source cell in the copy
// being read (as K1 does); K6's rows next to a ghost take the slab pull
// (lbm_pull_slab), which injects a ghost that is the driven row the same
// way, so nothing is precomputed before the first step.
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

// The rows of K2's grid: periodic in y; no row reads a ghost.
struct Periodic {
  int ny;
  __device__ __forceinline__ int below(int j) const { return j == 0 ? ny - 1 : j - 1; }
  __device__ __forceinline__ int above(int j) const { return j + 1 == ny ? 0 : j + 1; }
  __device__ __forceinline__ bool edge(int) const { return false; }
  __device__ __forceinline__ void pull_edge(const float*, int, const Cell&, const StepParams&,
                                            float*) const {}
};

// The rows of K6's shard: n body rows, the frozen ghost rows lo (row -1)
// and hi (row n) in their own buffers with their own plane strides, and the
// (n + 2, nx) obstacle slab; rows 0 and n - 1 (the edges) pull from the
// ghosts through lbm_pull_slab.
struct Ghosted {
  const float* lo;
  long long ps_lo;
  const float* hi;
  long long ps_hi;
  const uint8_t* obst;
  int n;
  int row_offset;
  __device__ __forceinline__ int below(int j) const { return j - 1; }
  __device__ __forceinline__ int above(int j) const { return j + 1; }
  __device__ __forceinline__ bool edge(int j) const { return j == 0 || j + 1 == n; }
  __device__ __forceinline__ void pull_edge(const float* a, int plane, const Cell& c,
                                            const StepParams& p, float t[9]) const {
    const Slab<float> s{a, plane, lo, ps_lo, hi, ps_hi};
    lbm_pull_slab<true>(s, n, obst, row_offset, c.j, c.i, p, t);
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

// The injection of pulled values from the driven row (row offset arow; -1
// for none), in lbm_pull()'s order.
__device__ __forceinline__ void inject(float t[9], const float* a, int plane,
                                       const uint8_t* wall, const Cell& c, int arow,
                                       const StepParams& p) {
  if (c.rj == arow) {
    t[1] = t[1] + gate(a, plane, wall, c.rj + c.iw, p.w1, p);
    t[3] = t[3] - gate(a, plane, wall, c.rj + c.ie, p.w1, p);
  }
  if (c.rs == arow) {
    t[5] = t[5] + gate(a, plane, wall, c.rs + c.iw, p.w2, p);
    t[6] = t[6] - gate(a, plane, wall, c.rs + c.ie, p.w2, p);
  }
  if (c.rn == arow) {
    t[7] = t[7] - gate(a, plane, wall, c.rn + c.ie, p.w2, p);
    t[8] = t[8] + gate(a, plane, wall, c.rn + c.iw, p.w2, p);
  }
}

// `nsteps` steps of an nrows x nx state from fa, ping-ponging with fb (see
// the note above).  wall: the obstacle bytes of the state's row 0, rows nx
// apart; arow: the offset (row x nx) of the driven row among the state's
// rows, or -1; partials, in 32-bit words (ops/resident_cuda.py
// partials_buffer): gridDim.x step counters kCounterWords apart, the band
// plan (gridDim.x x 4 int32) and nsteps x gridDim.x sums.
template <class Rows>
__device__ __forceinline__ void run(float* fa, float* fb, const uint8_t* __restrict__ wall,
                                    float* partials, float* tot_out, const StepParams& p,
                                    const Rows& rows, int nrows, int arow, int nsteps) {
  constexpr int kC = aa::kCells;
  __shared__ float sh[kThreads];
  __shared__ float wsum[kThreads / 32];
  const int nx = p.nx;
  const int plane = nrows * nx;
  const int G = gridDim.x;
  unsigned* counters = reinterpret_cast<unsigned*>(partials);
  unsigned* counter = counters + blockIdx.x * kCounterWords;
  const aa::Band bd = aa::band(reinterpret_cast<const int*>(partials + kCounterWords * G), 0, G);
  float* sums = partials + (kCounterWords + 4) * G;
  const unsigned base = __ldcg(counter);
  // The thread's first cell, and the move of kThreads cells, in rows and columns.
  const int c_first = bd.start + static_cast<int>(threadIdx.x);
  const int j_first = c_first / nx, i_first = c_first - j_first * nx;
  const int dj = kThreads / nx, di = kThreads - dj * nx;

  for (int t = 0; t < nsteps; ++t) {
    const float* a = (t & 1) ? fb : fa;
    float* d = (t & 1) ? fa : fb;
    if (t > 0) wait_blocks(counters, bd.dep_lo, bd.dep_n, G, base + t);
    float acc = 0.0f;
    int j = j_first, i = i_first;
    for (int c0 = c_first; c0 < bd.end; c0 += kC * kThreads) {
      Cell cl[kC];
      bool act[kC];
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        act[m] = c0 + m * kThreads < bd.end;
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
        if (rows.edge(cl[m].j)) {
          rows.pull_edge(a, plane, cl[m], p, tv[m]);
        } else {
          load_pull(a, plane, cl[m], tv[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        if (!act[m]) continue;
        const Cell& c = cl[m];
        if (!rows.edge(c.j)) inject(tv[m], a, plane, wall, c, arow, p);
        float out[9];
        acc = acc + lbm_collide(tv[m], wall[c.rj + c.i] != 0, p.omega, out);
#pragma unroll
        for (int k = 0; k < 9; ++k) d[k * plane + c.rj + c.i] = out[k];
      }
    }
    aa::step_end(acc, wsum, sums + t * G + blockIdx.x, counter, base + t + 1);
  }
  if (static_cast<int>(blockIdx.x) < nsteps) {  // it sums a step: wait for every block's last
    wait_blocks(counters, 0, G, G, base + nsteps);
  }
  for (int t = blockIdx.x; t < nsteps; t += G) lbm_reduce_row(sums, G, t, tot_out, sh);
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
