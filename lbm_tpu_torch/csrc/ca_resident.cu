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
// slab's two copies fit there, plus one grid barrier per step.  On the TPU
// the slab sat in VMEM for the sweep; here, as in K2 and K6, one
// cooperative launch with no more blocks than can be resident at once keeps
// two copies in the 50 MB L2, every block grid-stride looping over the
// cells, with cooperative_groups::this_grid().sync() between steps.  The
// wrapper (ops/ca_cuda.py) maps a shard only where 2 x 9 x (n + 2K) x nx x
// 4 B fit resident_cuda.L2_STATE_BUDGET.
//
// Design.  B9 computes every row of the slab at every step with a periodic
// roll inside the slab and lets the garbage the roll brings in shrink
// inward one row per step.  Here step t (0-based) computes only the rows
// that are still exact, [t + 1, n + 2K - t - 1): they read rows t .. n + 2K
// - t, which step t - 1 computed.  So nothing wraps in y, and step K - 1
// computes exactly the body rows, which it writes to the output window.
// Step 0 reads the three input windows directly (lo | body | hi, each with
// its own plane stride); steps 1 .. K - 2 ping-pong between the two scratch
// copies.  x wraps by index arithmetic.
//
// The driven row is found by global row, (row_offset - K + e) mod
// ny_global for extended row e, wherever it falls (body, either ghost
// region, or none), and injected from the source cell's values, as K1-slab
// does.
//
// Buffers written during the launch (the scratch copies, partials) are
// read through L2 only (__ldcg): L1 is not coherent with other SMs' writes
// across the barrier.  The input windows and the output window are not
// written / not read during the launch.
//
// |u|: per step each block sums its body cells in a fixed order into
// partials[step][block]; after the last step, one more barrier, and block b
// sums rows b, b + grid, ... in a fixed order into tot_out.  No float atomics.

#include <cooperative_groups.h>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(lbm::kThreads)
    lbm_ca_resident_kernel(lbm::Ext<float> in, float* sa, float* sb, const uint8_t* obst,
                           float* out, long long ps_out, float* partials, float* tot_out,
                           lbm::StepParams p, int row_offset, int ny_global) {
  __shared__ float sh[lbm::kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, K = in.K, n = in.n;
  const int ext = n + 2 * K;
  const long long plane = static_cast<long long>(ext) * nx;
  const int stride = gridDim.x * lbm::kThreads;
  const int first = blockIdx.x * lbm::kThreads + threadIdx.x;
  const lbm::Ext<float> scratch[2] = {{sa, plane, sa, plane, sa, plane, ext, 0},
                                      {sb, plane, sb, plane, sb, plane, ext, 0}};

  for (int t = 0; t < K; ++t) {
    const lbm::Ext<float>& src = (t == 0) ? in : scratch[(t - 1) & 1];
    float* dst = (t & 1) ? sb : sa;  // scratch[t & 1]
    const int e0 = t + 1;                   // rows [e0, ext - e0) are exact after step t
    const int ncell = (ext - 2 * e0) * nx;
    float acc = 0.0f;
    for (int c = first; c < ncell; c += stride) {
      const int e = e0 + c / nx;
      const int i = c - (e - e0) * nx;
      long long pss, psj, psn;
      const float* rs = lbm::lbm_ext_row(src, e - 1, nx, &pss);
      const float* rj = lbm::lbm_ext_row(src, e, nx, &psj);
      const float* rn = lbm::lbm_ext_row(src, e + 1, nx, &psn);
      const int g = lbm::lbm_wrap(row_offset - K + e, ny_global);
      const uint8_t* wj = obst + static_cast<size_t>(e) * nx;
      float tv[9], o[9];
      lbm::lbm_pull_3rows<true>(rs, pss, rj, psj, rn, psn, wj - nx, wj, wj + nx,
                                lbm::lbm_wrap(g - 1, ny_global) == p.accel_row,
                                g == p.accel_row,
                                lbm::lbm_wrap(g + 1, ny_global) == p.accel_row, i, p, tv);
      const float speed = lbm::lbm_collide(tv, wj[i] != 0, p.omega, o);
      if (e >= K && e < K + n) acc = acc + speed;
      if (t + 1 == K) {
        float* oc = out + static_cast<size_t>(e - K) * nx + i;
#pragma unroll
        for (int k = 0; k < 9; ++k) oc[k * ps_out] = o[k];
      } else {
        float* dc = dst + static_cast<size_t>(e) * nx + i;
#pragma unroll
        for (int k = 0; k < 9; ++k) dc[k * plane] = o[k];
      }
    }
    const float total = lbm::lbm_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = total;
    grid.sync();
  }
  for (int t = blockIdx.x; t < K; t += gridDim.x) {
    lbm::lbm_reduce_row(partials, gridDim.x, t, tot_out, sh);
  }
}

}  // namespace

extern "C" {

// Blocks of one K7 launch over an extended slab of ext x nx cells: no more
// than one per kThreads cells, and no more than can be resident on the
// device at once.  Returns <= 0 on error.
int lbm_ca_resident_grid(int ext, int nx, int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_ca_resident_kernel,
                                                    lbm::kThreads, 0) != cudaSuccess)
    return -1;
  const long long want = (static_cast<long long>(ext) * nx + lbm::kThreads - 1) / lbm::kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

// K7: advance the n body rows of one shard K steps into `out`, from lo (the
// K rows below), body and hi (the K rows above), each with its own plane
// stride in elements and a row stride of nx, in one cooperative launch of
// `grid` blocks (from lbm_ca_resident_grid).  sa and sb are scratch of
// 9 x (n + 2K) x nx floats each; obst the (n + 2K, nx) extended obstacle
// slab; row_offset the global row of body row 0; ny_global the grid's row
// count.  partials holds K x grid floats; tot_out receives the K per-level
// sums over the body's fluid cells.  Returns the launch's error code, or
// cudaGetLastError().
int lbm_ca_resident(const float* lo, long long ps_lo, const float* body, long long ps,
                    const float* hi, long long ps_hi, float* sa, float* sb, const uint8_t* obst,
                    float* out, long long ps_out, float* partials, float* tot_out, int n, int nx,
                    int K, int row_offset, int ny_global, int accel_row, float omega, float w1,
                    float w2, int grid, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || n < K || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{n + 2 * K, nx, accel_row, omega, w1, w2};
  lbm::Ext<float> in{lo, ps_lo, body, ps, hi, ps_hi, K, n};
  void* args[] = {&in, &sa, &sb, &obst, &out, &ps_out, &partials, &tot_out,
                  &p, &row_offset, &ny_global};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_ca_resident_kernel),
                                    dim3(grid), dim3(lbm::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
