// Shared per-cell D2Q9-BGK update for the CUDA kernels of lbm_tpu_torch.
//
// Both kernels (step.cu, resident.cu) pull the 9 values of a cell with
// lbm_pull() and update it with lbm_collide(), so they stay bitwise equal to
// each other and to the plain torch step (ops/stencil_math.py, which this
// file follows op for op, in the same association order).
//
// Bitwise equality with the torch step needs uncontracted IEEE float32: the
// library is built with --fmad=false (no a*b+c -> FMA), -prec-div=true and
// -prec-sqrt=true (correctly rounded / and sqrt), and never with
// --use_fast_math (ops/_build.py).
//
// Layout: f is (9, ny, nx) float32, plane k at f + k*ny*nx, row-major; the
// obstacle mask is (ny, nx) bytes, nonzero = wall.  Speed numbering as in
// core/lattice.py:
//
//     6 2 5
//     3 0 1        cx = (0, 1, 0,-1, 0, 1,-1,-1, 1)
//     7 4 8        cy = (0, 0, 1, 0,-1, 1, 1,-1,-1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lbm {

constexpr int kThreads = 256;  // threads per block of every kernel

// Float32 constants, rounded exactly as np.float32(...) on the host.
#define LBM_W0 (static_cast<float>(4.0 / 9.0))
#define LBM_W1 (static_cast<float>(1.0 / 9.0))
#define LBM_W2 (static_cast<float>(1.0 / 36.0))

struct StepParams {
  int ny;
  int nx;
  int accel_row;  // ny - 2: the driven row
  float omega;
  float w1;  // density * accel / 9
  float w2;  // density * accel / 36
};

// State loads.  kL2 = true reads through L2 only (ld.global.cg), bypassing
// the per-SM L1, which is not coherent with other SMs' writes: the persistent
// kernel reads, after a grid barrier, values other blocks wrote in the same
// launch.  The one-step kernel reads a buffer no one writes during its launch
// and takes the default cached load.
template <bool kL2>
__device__ __forceinline__ float lbm_load(const float* a) {
  if constexpr (kL2) {
    return __ldcg(a);
  } else {
    return *a;
  }
}

// Injection guard of the driven row, evaluated at the SOURCE cell (sj, si)
// on its pre-injection values: fluid, and f3 - w1, f6 - w2, f7 - w2 all
// strictly positive (SerialCode/d2q9-bgk.c:216-246).
template <bool kL2>
__device__ __forceinline__ float lbm_accel_gate(const float* f, const uint8_t* obst,
                                                size_t plane, int sj, int si,
                                                float w, const StepParams& p) {
  const size_t c = static_cast<size_t>(sj) * p.nx + si;
  const bool ok = !obst[c] && (lbm_load<kL2>(f + 3 * plane + c) - p.w1 > 0.0f) &&
                  (lbm_load<kL2>(f + 6 * plane + c) - p.w2 > 0.0f) &&
                  (lbm_load<kL2>(f + 7 * plane + c) - p.w2 > 0.0f);
  return ok ? w : 0.0f;
}

// Pull the 9 streamed values of cell (j, i): t[k] = f[k][(j-cy) mod ny][(i-cx) mod nx].
// The injection happens before streaming in the reference, so a value pulled
// from the driven row carries its source cell's own injection.  The guard is
// recomputed here from the source cell (the TPU kernel does the same for its
// ghost rows, lbm_tpu/ops/fused_pallas.py:316-325).
template <bool kL2>
__device__ __forceinline__ void lbm_pull(const float* f, const uint8_t* obst, int j,
                                         int i, const StepParams& p, float t[9]) {
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  const int js = (j == 0) ? p.ny - 1 : j - 1;      // source row of cy = +1
  const int jn = (j + 1 == p.ny) ? 0 : j + 1;      // source row of cy = -1
  const int iw = (i == 0) ? p.nx - 1 : i - 1;      // source column of cx = +1
  const int ie = (i + 1 == p.nx) ? 0 : i + 1;      // source column of cx = -1
  const size_t rj = static_cast<size_t>(j) * p.nx;
  const size_t rs = static_cast<size_t>(js) * p.nx;
  const size_t rn = static_cast<size_t>(jn) * p.nx;

  t[0] = lbm_load<kL2>(f + 0 * plane + rj + i);
  t[1] = lbm_load<kL2>(f + 1 * plane + rj + iw);
  t[2] = lbm_load<kL2>(f + 2 * plane + rs + i);
  t[3] = lbm_load<kL2>(f + 3 * plane + rj + ie);
  t[4] = lbm_load<kL2>(f + 4 * plane + rn + i);
  t[5] = lbm_load<kL2>(f + 5 * plane + rs + iw);
  t[6] = lbm_load<kL2>(f + 6 * plane + rs + ie);
  t[7] = lbm_load<kL2>(f + 7 * plane + rn + ie);
  t[8] = lbm_load<kL2>(f + 8 * plane + rn + iw);

  // Speeds 1, 3 come from row j; 5, 6 from row js; 7, 8 from row jn.
  if (j == p.accel_row) {
    t[1] = t[1] + lbm_accel_gate<kL2>(f, obst, plane, j, iw, p.w1, p);
    t[3] = t[3] - lbm_accel_gate<kL2>(f, obst, plane, j, ie, p.w1, p);
  }
  if (js == p.accel_row) {
    t[5] = t[5] + lbm_accel_gate<kL2>(f, obst, plane, js, iw, p.w2, p);
    t[6] = t[6] - lbm_accel_gate<kL2>(f, obst, plane, js, ie, p.w2, p);
  }
  if (jn == p.accel_row) {
    t[7] = t[7] - lbm_accel_gate<kL2>(f, obst, plane, jn, ie, p.w2, p);
    t[8] = t[8] + lbm_accel_gate<kL2>(f, obst, plane, jn, iw, p.w2, p);
  }
}

// Bounce-back on walls, paired-equilibrium BGK on fluid cells
// (ops/stencil_math.py moments + collide).  Returns |u| from the
// pre-collision moments on fluid cells and 0 on walls.
__device__ __forceinline__ float lbm_collide(const float t[9], bool wall, float omega,
                                             float out[9]) {
  const float rho =
      ((((((((t[0] + t[1]) + t[2]) + t[3]) + t[4]) + t[5]) + t[6]) + t[7]) + t[8]);
  const float u_x = (((t[1] + t[5]) + t[8]) - ((t[3] + t[6]) + t[7])) / rho;
  const float u_y = (((t[2] + t[5]) + t[6]) - ((t[4] + t[7]) + t[8])) / rho;
  const float u_sq = u_x * u_x + u_y * u_y;
  if (wall) {
    out[0] = t[0];
    out[1] = t[3];
    out[2] = t[4];
    out[3] = t[1];
    out[4] = t[2];
    out[5] = t[7];
    out[6] = t[8];
    out[7] = t[5];
    out[8] = t[6];
    return 0.0f;
  }
  const float usq_term = u_sq * 1.5f;
  const float w0rho = rho * LBM_W0;
  const float w1rho = rho * LBM_W1;
  const float w2rho = rho * LBM_W2;
  const float base = 1.0f - usq_term;
  float d[9];
  d[0] = w0rho * base;
  {
    const float a = w1rho * (base + (u_x * u_x) * 4.5f);
    const float b = w1rho * (u_x * 3.0f);
    d[1] = a + b;
    d[3] = a - b;
  }
  {
    const float a = w1rho * (base + (u_y * u_y) * 4.5f);
    const float b = w1rho * (u_y * 3.0f);
    d[2] = a + b;
    d[4] = a - b;
  }
  {
    const float u = u_x + u_y;
    const float a = w2rho * (base + (u * u) * 4.5f);
    const float b = w2rho * (u * 3.0f);
    d[5] = a + b;
    d[7] = a - b;
  }
  {
    const float u = u_y - u_x;
    const float a = w2rho * (base + (u * u) * 4.5f);
    const float b = w2rho * (u * 3.0f);
    d[6] = a + b;
    d[8] = a - b;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = t[k] + (d[k] - t[k]) * omega;
  return sqrtf(u_sq);
}

// Fixed-order tree sum of one value per thread over a kThreads block
// (run-to-run deterministic; no atomics).  Every thread of the block must
// call it; the result is valid in thread 0.
__device__ __forceinline__ float lbm_block_sum(float v, float* sh) {
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  sh[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = sh[tid] + sh[tid + s];
    __syncthreads();
  }
  const float total = sh[0];
  __syncthreads();  // sh may be reused right after
  return total;
}

// Second pass of the |u| reduction: block `row` sums partials[row][0..n)
// in a fixed order (strided per thread, then the tree) into out[row].
// Reads through L2: the persistent kernel calls it right after a grid
// barrier, on partials other blocks wrote.
__device__ __forceinline__ void lbm_reduce_row(const float* partials, int n, int row,
                                               float* out, float* sh) {
  const float* r = partials + static_cast<size_t>(row) * n;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n; b += kThreads) acc = acc + lbm_load<true>(r + b);
  const float total = lbm_block_sum(acc, sh);
  if (threadIdx.x == 0) out[row] = total;
}

}  // namespace lbm
