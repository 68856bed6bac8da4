// K3: the in-place persistent multi-step D2Q9-BGK kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_inplace_blocked_kernel
// (:601), float32 and int16 storage (K3 and K3-i16, one template): `chunk`
// steps in one launch on ONE copy of the state, updated in place, with the
// per-step |u| sums.  One f32 copy of a 1024^2 state is 36 MiB and fits the
// card's 50 MB L2 where the two copies of K2 (72 MiB) do not.
//
// Bound: 9 reads + 9 writes of state per cell-step, as K1/K2, from L2 while
// the copy stays there, plus one grid barrier per step.
//
// The TPU kernel is correct because its grid steps run in sequence: block j
// reads old rows >= jB plus a carried old row jB-1 (resident_pallas.py
// :573-598).  Blocks here run at once, so the in-place scheme is designed
// again, as the AA access pattern: steps alternate between two layouts of
// the one buffer A so that every slot a cell reads in a step is one that the
// same cell writes in that step.  No cell ever reads a value another cell
// wrote in the same step, so all cells run in parallel, one thread each, as
// in K2, with one grid barrier per step.
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
// Every state and guard load goes through L2 only (__ldcg): other blocks
// wrote them in the same launch.  No state pointer is __restrict__/const.
//
// |u|: per step each block reduces its cells in a fixed order into
// partials[step][block]; after the last step, one more barrier, and block b
// sums rows b, b + grid, ... in a fixed order into tot_out.  No float
// atomics, so a run repeats bitwise.

#include <cooperative_groups.h>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

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
__device__ __forceinline__ uint8_t stored_guard(const T q[9], bool fluid,
                                                const lbm::StepParams& p) {
  return lbm::lbm_guard(fluid, lbm::lbm_decode(q[3], 3, p), lbm::lbm_decode(q[6], 6, p),
                        lbm::lbm_decode(q[7], 7, p), p);
}

// At least 4 blocks per SM (62 registers): measured on the card at 1024^2,
// 29.0 us/step against 33.5 for the compiler's own 80-84 registers, and no
// faster at 5, 6 or 8 blocks (PERF.md, Findings PR 2).
template <typename T>
__global__ void __launch_bounds__(lbm::kThreads, 4)
    lbm_inplace_kernel(T* a, T* spare, const uint8_t* __restrict__ obst, uint8_t* gate,
                       float* partials, float* tot_out, lbm::StepParams p, int s0, int nsteps,
                       int first, int final_run) {
  __shared__ float sh[lbm::kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, ny = p.ny, ar = p.accel_row;
  const int ncell = ny * nx;
  const size_t plane = static_cast<size_t>(ncell);
  const int stride = gridDim.x * lbm::kThreads;

  if (first) {  // canonical -> Q layout, and the guards of step 0
    for (int c = blockIdx.x * lbm::kThreads + threadIdx.x; c < ncell; c += stride) {
      T v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = __ldcg(a + k * plane + c);
#pragma unroll
      for (int k = 0; k < 9; ++k) a[opp(k) * plane + c] = v[k];
      const int j = c / nx;
      if (j == ar) gate[c - j * nx] = stored_guard(v, obst[c] == 0, p);
    }
    grid.sync();
  }

  for (int t = 0; t < nsteps; ++t) {
    const int s = s0 + t;
    const bool neighbour = (s & 1) == 0;  // step s reads Q (even s) or P (odd s)
    const uint8_t* gcur = gate + (s & 1) * nx;
    uint8_t* gnext = gate + (~s & 1) * nx;
    const bool last = final_run && t + 1 == nsteps;
    float acc = 0.0f;
    for (int c = blockIdx.x * lbm::kThreads + threadIdx.x; c < ncell; c += stride) {
      const int j = c / nx;
      const int i = c - j * nx;
      const int js = (j == 0) ? ny - 1 : j - 1;
      const int jn = (j + 1 == ny) ? 0 : j + 1;
      const int iw = (i == 0) ? nx - 1 : i - 1;
      const int ie = (i + 1 == nx) ? 0 : i + 1;
      const int src_row[3] = {js, j, jn};  // source row of cy = +1, 0, -1
      const int src_col[3] = {iw, i, ie};  // source column of cx = +1, 0, -1
      float tv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int sj = src_row[1 - cy(k)];
        const int si = src_col[1 - cx(k)];
        const size_t slot = neighbour
                                ? opp(k) * plane + static_cast<size_t>(sj) * nx + si
                                : k * plane + c;
        tv[k] = lbm::lbm_load<true>(a + slot, k, p);
        // Injection of the source cell when it is on the driven row; a false
        // guard adds 0.0f, as K1 and the plain version do.
        if ((k == 1 || k == 3 || k >= 5) && sj == ar) {
          const float w = (k == 1 || k == 3) ? p.w1 : p.w2;
          const float d = __ldcg(gcur + si) ? w : 0.0f;
          tv[k] = (k == 1 || k == 5 || k == 8) ? tv[k] + d : tv[k] - d;
        }
      }
      const bool wall = obst[c] != 0;
      float out[9];
      acc = acc + lbm::lbm_collide(tv, wall, p.omega, out);
      T q[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = lbm::lbm_encode<T>(out[k], k, p);
      if (neighbour && last) {
#pragma unroll
        for (int k = 0; k < 9; ++k) spare[k * plane + c] = q[k];
      } else if (neighbour) {
        const int dst_row[3] = {jn, j, js};  // destination row of cy = +1, 0, -1
        const int dst_col[3] = {ie, i, iw};
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          a[k * plane + static_cast<size_t>(dst_row[1 - cy(k)]) * nx + dst_col[1 - cx(k)]] = q[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) a[(last ? k : opp(k)) * plane + c] = q[k];
      }
      if (j == ar && !last) gnext[i] = stored_guard(q, !wall, p);
    }
    const float total = lbm::lbm_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = total;
    grid.sync();
  }
  for (int t = blockIdx.x; t < nsteps; t += gridDim.x) {
    lbm::lbm_reduce_row(partials, gridDim.x, t, tot_out, sh);
  }
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
// `codec` (host memory) for i16 = 1.  partials holds nsteps x grid floats;
// tot_out receives nsteps per-step sums.  Returns the launch's error code,
// or cudaGetLastError().
int lbm_inplace_chunk(void* a, void* spare, const uint8_t* obst, uint8_t* gate, float* partials,
                      float* tot_out, int ny, int nx, int accel_row, float omega, float w1,
                      float w2, int i16, const float* codec, int s0, int nsteps, int first,
                      int final_run, int grid, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsteps < 1 || grid < 1 || s0 < 0 || (first && s0 != 0))
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
