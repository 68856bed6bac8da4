// K8: the in-place sweep of the exact communication-avoiding mode (ca), for
// Hopper.
//
// K8 replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_ca_inplace_kernel
// (:1643, body _inplace_slab_sweep :1474, entry make_ca_inplace_runner
// :1676), float32 and int16 storage (K8 and K8-i16, one template): K exact
// steps of one shard from its ghost-extended slab [K rows below | n body
// rows | K rows above] on ONE scratch copy of the slab, updated in place, in
// one launch.  The body after the launch is K synchronous exchanged steps,
// bitwise (int16: K sync-i16 steps, quantized every step as B10 does,
// :1704-1709).
//
// Bound: 9 reads + 9 writes of state per cell-step of the extended slab,
// from L2 while its one copy stays there (the wrappers map a slab only
// where it fits inplace_cuda.L2_INPLACE_BUDGET), plus the steps' waits.
// On the 256x1024 shard at K = 8 half of the parent kernel's time was its
// step floor (the grid barrier and the block sum, no cell: 3.95 of 7.83
// us/step; PERF.md Findings PR 8).
//
// Design: K3's AA access pattern (csrc/inplace.cu) on the extended slab, so
// that every cell reads and writes only its own slots and all cells run in
// parallel.  Step t (0-based) computes only the rows still exact,
// [t + 1, ext - t - 1), ext = n + 2K, so nothing wraps in y (B10 rolls the
// whole slab and lets the garbage shrink inward; the exact rows are the
// same):
//
// - step 0 pulls from the three input windows (lo | body | hi, each with
//   its own plane stride) and writes the P layout, A[k][x + c_k];
// - odd steps read P (A[k][x]) and write Q (A[opp(k)][x]); even steps from
//   2 read Q (A[opp(k)][x - c_k]) and write P;
// - the last step computes the body rows and writes them, canonical, to
//   the output window: another buffer, so an odd K needs no second copy.
//
// Work map and synchronisation as K3's (aa_inplace.cuh): each step's rows
// are split evenly over all the blocks afresh (the host's band plan, one
// entry per step and block), so the shrinking steps never leave a near-empty
// round; a block's step t + 1 waits only for the blocks whose step-t cells
// lie within one row of its own; the last step ends in a grid barrier
// before the |u| pass.
//
// The driven row sits at extended row `drow` (from the shard's row offset;
// -1 when the slab holds none; at most one image, as ext <= ny_global), in
// the body or in either ghost region.  Step 0 recomputes its injection
// guard from the window values; later steps read it from a byte per
// column, double-buffered by step parity, that the cell storing the driven
// row's values writes from its stored (decoded) values, as K3 does.
//
// Scratch and guard bytes are written during the launch and read through
// L2 only (__ldcg).  |u|: per step each block sums its body cells in a fixed
// order into its partial; after the last step, block b sums rows b,
// b + grid, ... in a fixed order into tot_out, or adds them to it
// (accumulate: ca's split sub-slabs, in part order).  No float atomics.

#include <cooperative_groups.h>

#include "aa_inplace.cuh"

namespace cg = cooperative_groups;

namespace {

using lbm::aa::Cell;

template <typename T>
__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_ca_inplace_kernel(lbm::Ext<T> in, T* a, const uint8_t* __restrict__ obst, uint8_t* gate,
                          T* out, long long ps_out, float* partials, float* tot_out,
                          lbm::StepParams p, int drow, int accumulate) {
  namespace aa = lbm::aa;
  constexpr int kC = aa::kCells;
  __shared__ float sh[lbm::kThreads];
  __shared__ float wsum[lbm::kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, K = in.K, n = in.n;
  const int ext = n + 2 * K;
  const int plane = ext * nx;
  const int G = gridDim.x;
  const int* plan = reinterpret_cast<const int*>(partials);
  unsigned* flags = reinterpret_cast<unsigned*>(partials) + 4 * K * G;
  float* sums = partials + 4 * K * G + G;
  const unsigned base = __ldcg(flags + blockIdx.x);
  const int dj = lbm::kThreads / nx, di = lbm::kThreads - dj * nx;
  // The driven row's offset; body rows [K, K + n) count in |u|.
  const int drow_off = drow < 0 ? -1 : drow * nx;
  const int body_lo = K * nx, body_hi = (K + n) * nx;

  aa::Band next = aa::band(plan, 0, G);
  for (int t = 0; t < K; ++t) {
    const aa::Band bd = next;
    if (t + 1 < K) next = aa::band(plan, t + 1, G);  // in flight during this step
    const bool last = t + 1 == K;
    const bool neighbour = (t & 1) == 0;  // reads Q (t >= 2) or the windows (t = 0)
    const uint8_t* gcur = gate + (t & 1) * nx;
    uint8_t* gnext = gate + (~t & 1) * nx;
    if (t > 0) aa::band_wait(flags, bd, G, base + t);
    float acc = 0.0f;
    const int c_first = bd.start + static_cast<int>(threadIdx.x);
    int e = c_first / nx, i = c_first - e * nx;
    for (int c0 = c_first; c0 < bd.end; c0 += kC * lbm::kThreads) {
      Cell cl[kC];
      bool act[kC];
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        act[m] = c0 + m * lbm::kThreads < bd.end;
        cl[m] = aa::cell_at(e, i, e - 1, e + 1, nx);
        i += di;
        e += dj;
        if (i >= nx) {
          i -= nx;
          ++e;
        }
      }
      float tv[kC][9];
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        if (!act[m]) continue;
        const Cell& c = cl[m];
        if (t == 0) {
          long long pss, psj, psn;
          const T* rs = lbm::lbm_ext_row(in, c.j - 1, nx, &pss);
          const T* rj = lbm::lbm_ext_row(in, c.j, nx, &psj);
          const T* rn = lbm::lbm_ext_row(in, c.j + 1, nx, &psn);
          const uint8_t* wj = obst + c.rj;
          lbm::lbm_pull_3rows<true>(rs, pss, rj, psj, rn, psn, wj - nx, wj, wj + nx,
                                    c.rs == drow_off, c.rj == drow_off, c.rn == drow_off, c.i,
                                    p, tv[m]);
        } else if (neighbour) {
          aa::load_q(a, plane, c, p, tv[m]);
        } else {
          aa::load_p(a, plane, c, p, tv[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kC; ++m) {
        if (!act[m]) continue;
        const Cell& c = cl[m];
        if (t > 0) {
          aa::inject(tv[m], gcur, c.rs == drow_off, c.rj == drow_off, c.rn == drow_off, c, p);
        }
        const bool wall = obst[c.rj + c.i] != 0;
        float o[9];
        const float speed = lbm::lbm_collide(tv[m], wall, p.omega, o);
        if (c.rj >= body_lo && c.rj < body_hi) acc = acc + speed;
        T q[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) q[k] = lbm::lbm_encode<T>(o[k], k, p);
        if (last) {
          T* oc = out + static_cast<size_t>(c.rj - body_lo + c.i);
#pragma unroll
          for (int k = 0; k < 9; ++k) oc[k * ps_out] = q[k];
        } else if (neighbour) {
          aa::store_p(a, plane, c, q);
        } else {
          aa::store_local(a, plane, c.rj + c.i, q, false);
        }
        if (c.rj == drow_off && !last) gnext[c.i] = aa::stored_guard(q, !wall, p);
      }
    }
    aa::step_end(acc, wsum, sums + t * G + blockIdx.x, flags + blockIdx.x, base + t + 1);
  }
  grid.sync();
  for (int t = blockIdx.x; t < K; t += G) {
    const float* r = sums + static_cast<size_t>(t) * G;
    float acc = 0.0f;
    for (int b = threadIdx.x; b < G; b += lbm::kThreads) acc = acc + __ldcg(r + b);
    const float total = lbm::lbm_block_sum(acc, sh);
    if (threadIdx.x == 0) tot_out[t] = accumulate ? tot_out[t] + total : total;
  }
}

template <typename T>
int ca_inplace_grid(int ext, int nx, int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_ca_inplace_kernel<T>,
                                                    lbm::kThreads, 0) != cudaSuccess)
    return -1;
  const long long want = (static_cast<long long>(ext) * nx + lbm::kThreads - 1) / lbm::kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T>
int ca_inplace(lbm::Ext<T> in, T* a, const uint8_t* obst, uint8_t* gate, T* out,
               long long ps_out, float* partials, float* tot_out, lbm::StepParams p, int drow,
               int accumulate, int grid, cudaStream_t s) {
  void* args[] = {&in, &a, &obst, &gate, &out, &ps_out, &partials, &tot_out, &p, &drow,
                  &accumulate};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lbm_ca_inplace_kernel<T>), dim3(grid), dim3(lbm::kThreads),
      args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of one cooperative K8 launch over an extended slab of ext x nx
// cells (i16 selects the int16 instantiation): no more than one per
// kThreads cells, and no more than can be resident at once.  Returns <= 0
// on error.
int lbm_ca_inplace_grid(int ext, int nx, int i16, int device) {
  return i16 ? ca_inplace_grid<int16_t>(ext, nx, device) : ca_inplace_grid<float>(ext, nx, device);
}

// K8: advance the n body rows of one shard (or sub-slab) K steps into
// `out`, from lo (the K rows below), body and hi (the K rows above), each
// with its own plane stride in elements and a row stride of nx, in one
// cooperative launch of `grid` blocks (from lbm_ca_inplace_grid).  `a` is
// scratch of 9 x (n + 2K) x nx values of the state's type, `gate` 2 x nx
// bytes; obst the (n + 2K, nx) extended obstacle slab; drow the extended
// row of the driven row, or -1.  partials holds, in 32-bit words, the band
// plan of this slab and grid (K x grid x 4 int32: ops/inplace_cuda.py
// band_plan), grid step counters (zero before the first launch on the
// buffer; the kernel keeps them equal between launches) and K x grid
// floats; tot_out receives the K per-level sums over the body's fluid cells
// (accumulate = 1: adds them to it).  float32 state for i16 = 0, int16 with
// the 27 codec constants at `codec` (host memory) for i16 = 1.  9 x (n + 2K)
// x nx must stay below 2^31 (32-bit offsets in the scratch).  Returns the
// launch's error code, or cudaGetLastError().
int lbm_ca_inplace(const void* lo, long long ps_lo, const void* body, long long ps,
                   const void* hi, long long ps_hi, void* a, uint8_t* gate, const uint8_t* obst,
                   void* out, long long ps_out, float* partials, float* tot_out, int n, int nx,
                   int K, int drow, int accumulate, int accel_row, float omega, float w1,
                   float w2, int i16, const float* codec, int grid, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || n < K || grid < 1 || nx < 1 || drow >= n + 2 * K ||
      9LL * (n + 2 * K) * nx >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lbm::StepParams p{n + 2 * K, nx, accel_row, omega, w1, w2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    using T = int16_t;
    const lbm::Ext<T> in{static_cast<const T*>(lo), ps_lo, static_cast<const T*>(body), ps,
                         static_cast<const T*>(hi), ps_hi, K, n};
    return ca_inplace(in, static_cast<T*>(a), obst, gate, static_cast<T*>(out), ps_out,
                      partials, tot_out, p, drow, accumulate, grid, s);
  }
  using T = float;
  const lbm::Ext<T> in{static_cast<const T*>(lo), ps_lo, static_cast<const T*>(body), ps,
                       static_cast<const T*>(hi), ps_hi, K, n};
  return ca_inplace(in, static_cast<T*>(a), obst, gate, static_cast<T*>(out), ps_out, partials,
                    tot_out, p, drow, accumulate, grid, s);
}

}  // extern "C"
