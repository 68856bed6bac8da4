// K3: the in-place persistent multi-step D2Q9-BGK kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_inplace_blocked_kernel
// (:601), float32 and int16 storage (K3 and K3-i16, one template): `chunk`
// steps in one launch on ONE copy of the state, updated in place, with the
// per-step |u| sums.  One f32 copy of a 1024^2 state is 36 MiB and fits the
// card's 50 MB L2 where the two copies of K2 (72 MiB) do not.
//
// Bound: 9 reads + 9 writes of state per cell-step, as K1/K2, from L2 while
// the copy stays there (a persistent in-place copy of 36 MiB ran 4.1 TB/s
// with a grid barrier per pass and 6.0 TB/s without: the barrier, not L2,
// is the tier's limit; PERF.md Findings PR 8).
//
// The TPU kernel is correct because its grid steps run in sequence: block j
// reads old rows >= jB plus a carried old row jB-1 (resident_pallas.py
// :573-598).  Blocks here run at once, so the in-place scheme is designed
// again, as the AA access pattern: steps alternate between two layouts of
// the one buffer A so that every slot a cell reads in a step is one that the
// same cell writes in that step.  No cell ever reads a value another cell
// wrote in the same step, so all cells of a step run in parallel.
//
// - Q layout, A[opp(k)][x] = F[k][x]: the post-collision values of cell x
//   with each pair of opposite speeds swapped.  A "neighbour" step reads
//   t[k] = A[opp(k)][x - c_k] (the pull of streaming), collides, and writes
//   out[k] to A[k][x + c_k], a slot that in this step only cell x reads:
//   the P layout.
// - P layout, A[k][x] = F[k][x - c_k]: the streamed (pre-collision) values.
//   A "local" step reads t[k] = A[k][x], collides, and writes out[k] to
//   A[opp(k)][x]: the Q layout again.
// - A run starts from the canonical layout A[k][x] = F[k][x] (what the
//   program holds between runs): the first launch swaps each cell's opposite
//   speeds (Q).  Steps then go neighbour, local, neighbour, ...  The last
//   step writes the canonical layout: a local step writes out[k] to A[k][x];
//   a neighbour step (odd step counts) writes it to a second buffer, the
//   only time that buffer is touched.
// - Driven row.  The injection (before streaming, at the source cell, from
//   its own pre-injection values) is applied by the reader, as K1 does, but
//   the guard cannot be recomputed there: the source cell's f3, f6, f7 sit
//   in slots other cells own.  So, as B3 carries its `adj` row
//   (resident_pallas.py:649-655), the cell that stores a driven-row value
//   also stores its guard, a byte per column double-buffered by step
//   parity, from the stored (dequantized) values.  The injected value is
//   never requantized, as in B1/B3.
//
// The work map and the synchronisation are those of aa_inplace.cuh: each
// block owns one even share of the cells (the host's band plan, the same
// every step), each thread kCells of them per round with all their loads in
// flight before the first collide, rows and columns from counters, 32-bit
// offsets; a block's next step waits only for the blocks within one row of
// its cells (periodic in y).  The first launch of a run swaps the layout and
// ends in a grid barrier; the last step of every launch in one, before the
// |u| pass.  Every state and guard load goes through L2 only (__ldcg):
// other blocks wrote them in the same launch.  No state pointer is
// __restrict__/const.
//
// |u|: per step each block sums its cells in a fixed order (per thread in
// cell order, per warp a butterfly, the warps in order) into its partial;
// after the last step, block b sums rows b, b + grid, ... in a fixed order
// into tot_out.  No float atomics, so a run repeats bitwise.

#include <cooperative_groups.h>

#include "aa_inplace.cuh"

namespace cg = cooperative_groups;

namespace {

using lbm::aa::Cell;

template <typename T>
__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_inplace_kernel(T* a, T* spare, const uint8_t* __restrict__ obst, uint8_t* gate,
                       float* partials, float* tot_out, lbm::StepParams p, int s0, int nsteps,
                       int first, int final_run) {
  namespace aa = lbm::aa;
  constexpr int kC = aa::kCells;
  __shared__ float sh[lbm::kThreads];
  __shared__ float wsum[lbm::kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, ny = p.ny, ar = p.accel_row;
  const int plane = ny * nx;
  const int G = gridDim.x;
  const aa::Band bd = aa::band(reinterpret_cast<const int*>(partials), 0, G);
  unsigned* flags = reinterpret_cast<unsigned*>(partials) + 4 * G;
  float* sums = partials + 5 * G;
  const unsigned base = __ldcg(flags + blockIdx.x);
  // The thread's first cell, and the move of kThreads cells, in rows and columns.
  const int c_first = bd.start + static_cast<int>(threadIdx.x);
  const int j_first = c_first / nx, i_first = c_first - j_first * nx;
  const int arow = ar * nx;  // the driven row's offset
  const int dj = lbm::kThreads / nx, di = lbm::kThreads - dj * nx;

  if (first) {  // canonical -> Q layout, and the guards of step 0
    for (int c = c_first; c < bd.end; c += lbm::kThreads) {
      T v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = __ldcg(a + k * plane + c);
#pragma unroll
      for (int k = 0; k < 9; ++k) a[aa::opp(k) * plane + c] = v[k];
      const int j = c / nx;
      if (j == ar) gate[c - j * nx] = aa::stored_guard(v, obst[c] == 0, p);
    }
    grid.sync();
  }

  for (int t = 0; t < nsteps; ++t) {
    const int s = s0 + t;
    const bool neighbour = (s & 1) == 0;  // step s reads Q (even s) or P (odd s)
    const uint8_t* gcur = gate + (s & 1) * nx;
    uint8_t* gnext = gate + (~s & 1) * nx;
    const bool last = final_run && t + 1 == nsteps;
    if (t > 0) aa::band_wait(flags, bd, G, base + t);
    float acc = 0.0f;
    int j = j_first, i = i_first;
    for (int c0 = c_first; c0 < bd.end; c0 += kC * lbm::kThreads) {
      Cell cl[kC];
      bool act[kC];
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        act[m] = c0 + m * lbm::kThreads < bd.end;
        cl[m] = aa::cell_at(j, i, j == 0 ? ny - 1 : j - 1, j + 1 == ny ? 0 : j + 1, nx);
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
        if (act[m]) {
          if (neighbour) {
            aa::load_q(a, plane, cl[m], p, tv[m]);
          } else {
            aa::load_p(a, plane, cl[m], p, tv[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        if (!act[m]) continue;
        const Cell& c = cl[m];
        aa::inject(tv[m], gcur, c.rs == arow, c.rj == arow, c.rn == arow, c, p);
        const bool wall = obst[c.rj + c.i] != 0;
        float out[9];
        acc = acc + lbm::lbm_collide(tv[m], wall, p.omega, out);
        T q[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) q[k] = lbm::lbm_encode<T>(out[k], k, p);
        if (neighbour && last) {
          aa::store_local(spare, plane, c.rj + c.i, q, true);
        } else if (neighbour) {
          aa::store_p(a, plane, c, q);
        } else {
          aa::store_local(a, plane, c.rj + c.i, q, last);
        }
        if (c.rj == arow && !last) gnext[c.i] = aa::stored_guard(q, !wall, p);
      }
    }
    aa::step_end(acc, wsum, sums + t * G + blockIdx.x, flags + blockIdx.x, base + t + 1);
  }
  grid.sync();
  for (int t = blockIdx.x; t < nsteps; t += G) lbm::lbm_reduce_row(sums, G, t, tot_out, sh);
}

template <typename T>
int inplace_grid(int ny, int nx, int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_inplace_kernel<T>,
                                                    lbm::kThreads, 0) != cudaSuccess)
    return -1;
  const long long want = (static_cast<long long>(ny) * nx + lbm::kThreads - 1) / lbm::kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T>
int inplace_chunk(T* a, T* spare, const uint8_t* obst, uint8_t* gate, float* partials,
                  float* tot_out, const lbm::StepParams& p, int s0, int nsteps, int first,
                  int final_run, int grid, cudaStream_t s) {
  lbm::StepParams pp = p;
  void* args[] = {&a, &spare, &obst, &gate, &partials, &tot_out, &pp, &s0, &nsteps, &first,
                  &final_run};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lbm_inplace_kernel<T>), dim3(grid), dim3(lbm::kThreads),
      args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of one cooperative K3 launch over ny x nx cells: no more than one
// per kThreads cells, and no more than can be resident on the device at
// once.  i16 selects the int16 instantiation.  Returns <= 0 on error.
int lbm_inplace_grid(int ny, int nx, int i16, int device) {
  return i16 ? inplace_grid<int16_t>(ny, nx, device) : inplace_grid<float>(ny, nx, device);
}

// Run steps s0 .. s0 + nsteps - 1 of a run in place on `a` in one
// cooperative launch of `grid` blocks (from lbm_inplace_grid).  The run's
// first launch passes first = 1 (a holds the canonical layout) and s0 = 0;
// its last passes final_run = 1, after which the canonical state is in `a`
// for an even total step count and in `spare` for an odd one.  Between
// launches of a run, `a` and `gate` (2 x nx bytes) hold the run's state.
// The state is float32 for i16 = 0, int16 with the 27 codec constants at
// `codec` (host memory) for i16 = 1.  partials holds, in 32-bit words,
// the band plan of this grid (grid x 4 int32: ops/inplace_cuda.py
// band_plan), grid step counters (zero before a runner's first launch; the
// kernel keeps them equal between launches) and nsteps x grid floats;
// tot_out receives nsteps per-step sums.  9 x ny x nx must stay below 2^31
// (32-bit offsets).  Returns the launch's error code, or
// cudaGetLastError().
int lbm_inplace_chunk(void* a, void* spare, const uint8_t* obst, uint8_t* gate, float* partials,
                      float* tot_out, int ny, int nx, int accel_row, float omega, float w1,
                      float w2, int i16, const float* codec, int s0, int nsteps, int first,
                      int final_run, int grid, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsteps < 1 || grid < 1 || s0 < 0 || (first && s0 != 0) || ny < 1 || nx < 1 ||
      9LL * ny * nx >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return inplace_chunk(static_cast<int16_t*>(a), static_cast<int16_t*>(spare), obst, gate,
                         partials, tot_out, p, s0, nsteps, first, final_run, grid, s);
  }
  return inplace_chunk(static_cast<float*>(a), static_cast<float*>(spare), obst, gate, partials,
                       tot_out, p, s0, nsteps, first, final_run, grid, s);
}

}  // extern "C"
