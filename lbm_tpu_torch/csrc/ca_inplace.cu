// K8: the in-place sweep of the exact communication-avoiding mode (ca), and
// K9: the HBM-parts sweep that runs the same kernel on row parts of one
// grid, for Hopper.
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
// K9 replaces lbm_tpu/ops/hbm_pallas.py::_hbm_sweep_kernel (:157, entries
// make_sweep :272 and make_run_all :354), float32: K steps of the whole
// grid as P row parts of R rows, each part's slab extended by K rows on
// each side (periodic wrap: its windows are rows of the input state), swept
// by K8's kernel in the scratch copy, its body rows written to the other
// state buffer.  The parts run one after the other on one stream: B7's
// triple-buffered DMA pipeline, which overlaps a part's load with the
// previous part's compute, is not ported (a TMA/mbarrier pipeline is later
// work).
//
// Bound: 9 reads + 9 writes of state per cell-step of the extended slab,
// from L2 while its one copy stays there (the wrappers map a slab only
// where it fits inplace_cuda.L2_INPLACE_BUDGET), plus one grid barrier per
// step; K9 also reads each part's slab from device memory and writes its
// body back once per sweep.
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
// The driven row sits at extended row `drow` (from the shard's row offset;
// -1 when the slab holds none; at most one image, as ext <= ny_global), in
// the body or in either ghost region.  Step 0 recomputes its injection
// guard from the window values; later steps read it from a byte per
// column, double-buffered by step parity, that the cell storing the driven
// row's values writes from its stored (decoded) values, as K3 does.
//
// Scratch and guard bytes are written during the launch and read through
// L2 only (__ldcg).  |u|: per step each block sums its body cells in a fixed
// order into partials[step][block]; after the last step, block b sums rows
// b, b + grid, ... in a fixed order into tot_out, or adds them to it
// (accumulate: K9's parts and ca's split sub-slabs, in part order).  No
// float atomics.

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

// K3's occupancy: at least 4 blocks per SM.
template <typename T>
__global__ void __launch_bounds__(lbm::kThreads, 4)
    lbm_ca_inplace_kernel(lbm::Ext<T> in, T* a, const uint8_t* __restrict__ obst, uint8_t* gate,
                          T* out, long long ps_out, float* partials, float* tot_out,
                          lbm::StepParams p, int drow, int accumulate) {
  __shared__ float sh[lbm::kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, K = in.K, n = in.n;
  const int ext = n + 2 * K;
  const size_t plane = static_cast<size_t>(ext) * nx;
  const int stride = gridDim.x * lbm::kThreads;
  const int first = blockIdx.x * lbm::kThreads + threadIdx.x;

  for (int t = 0; t < K; ++t) {
    const bool last = t + 1 == K;
    const bool neighbour = (t & 1) == 0;  // reads Q (t >= 2) or the windows (t = 0)
    const uint8_t* gcur = gate + (t & 1) * nx;
    uint8_t* gnext = gate + (~t & 1) * nx;
    const int e0 = t + 1;  // rows [e0, ext - e0) are exact after step t
    const int ncell = (ext - 2 * e0) * nx;
    float acc = 0.0f;
    for (int c = first; c < ncell; c += stride) {
      const int e = e0 + c / nx;
      const int i = c - (e - e0) * nx;
      const int iw = (i == 0) ? nx - 1 : i - 1;
      const int ie = (i + 1 == nx) ? 0 : i + 1;
      const uint8_t* wj = obst + static_cast<size_t>(e) * nx;
      float tv[9];
      if (t == 0) {
        long long pss, psj, psn;
        const T* rs = lbm::lbm_ext_row(in, e - 1, nx, &pss);
        const T* rj = lbm::lbm_ext_row(in, e, nx, &psj);
        const T* rn = lbm::lbm_ext_row(in, e + 1, nx, &psn);
        lbm::lbm_pull_3rows<true>(rs, pss, rj, psj, rn, psn, wj - nx, wj, wj + nx,
                                  e - 1 == drow, e == drow, e + 1 == drow, i, p, tv);
      } else {
        const int src_row[3] = {e - 1, e, e + 1};  // source row of cy = +1, 0, -1
        const int src_col[3] = {iw, i, ie};        // source column of cx = +1, 0, -1
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int sj = src_row[1 - cy(k)];
          const int si = src_col[1 - cx(k)];
          const size_t slot = neighbour
                                  ? opp(k) * plane + static_cast<size_t>(sj) * nx + si
                                  : k * plane + static_cast<size_t>(e) * nx + i;
          tv[k] = lbm::lbm_load<true>(a + slot, k, p);
          // Injection of the source cell when it is on the driven row; a
          // false guard adds 0.0f, as K1 and the plain version do.
          if ((k == 1 || k == 3 || k >= 5) && sj == drow) {
            const float w = (k == 1 || k == 3) ? p.w1 : p.w2;
            const float d = __ldcg(gcur + si) ? w : 0.0f;
            tv[k] = (k == 1 || k == 5 || k == 8) ? tv[k] + d : tv[k] - d;
          }
        }
      }
      const bool wall = wj[i] != 0;
      float o[9];
      const float speed = lbm::lbm_collide(tv, wall, p.omega, o);
      if (e >= K && e < K + n) acc = acc + speed;
      T q[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = lbm::lbm_encode<T>(o[k], k, p);
      if (last) {
        T* oc = out + static_cast<size_t>(e - K) * nx + i;
#pragma unroll
        for (int k = 0; k < 9; ++k) oc[k * ps_out] = q[k];
      } else if (neighbour) {
        const int dst_row[3] = {e + 1, e, e - 1};  // destination row of cy = +1, 0, -1
        const int dst_col[3] = {ie, i, iw};
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          a[k * plane + static_cast<size_t>(dst_row[1 - cy(k)]) * nx + dst_col[1 - cx(k)]] = q[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) a[opp(k) * plane + static_cast<size_t>(e) * nx + i] = q[k];
      }
      if (e == drow && !last) gnext[i] = stored_guard(q, !wall, p);
    }
    const float total = lbm::lbm_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = total;
    grid.sync();
  }
  for (int t = blockIdx.x; t < K; t += gridDim.x) {
    const float* r = partials + static_cast<size_t>(t) * gridDim.x;
    float acc = 0.0f;
    for (int b = threadIdx.x; b < gridDim.x; b += lbm::kThreads) acc = acc + __ldcg(r + b);
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
// row of the driven row, or -1.  partials holds K x grid floats; tot_out
// receives the K per-level sums over the body's fluid cells (accumulate = 1:
// adds them to it).  float32 state for i16 = 0, int16 with the 27 codec
// constants at `codec` (host memory) for i16 = 1.  Returns the launch's
// error code, or cudaGetLastError().
int lbm_ca_inplace(const void* lo, long long ps_lo, const void* body, long long ps,
                   const void* hi, long long ps_hi, void* a, uint8_t* gate, const uint8_t* obst,
                   void* out, long long ps_out, float* partials, float* tot_out, int n, int nx,
                   int K, int drow, int accumulate, int accel_row, float omega, float w1,
                   float w2, int i16, const float* codec, int grid, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || n < K || grid < 1 || drow >= n + 2 * K) {
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

// K9: one K-step sweep of the whole ny x nx float32 grid from fin into fout
// (another buffer), as ny / R row parts of R rows (R divides ny, K <= R,
// R + 2K <= ny), one K8 launch each, in order.  Part q reads rows
// [qR - K, qR + R + K) mod ny of fin (three windows that never straddle the
// wrap), sweeps them in the scratch `a` (9 x (R + 2K) x nx floats; gate
// 2 x nx bytes) with obstacle slab obst_parts[q] ((R + 2K) x nx bytes each)
// and writes its R body rows to fout.  partials holds K x grid floats
// (grid from lbm_ca_inplace_grid(R + 2K, nx, 0, device)); tot_out receives
// the K per-level sums, the parts added in order.  Returns the first CUDA
// error, or 0.
int lbm_hbm_sweep(const float* fin, float* fout, const uint8_t* obst_parts, float* a,
                  uint8_t* gate, float* partials, float* tot_out, int ny, int nx, int R, int K,
                  int accel_row, float omega, float w1, float w2, int grid, void* stream,
                  int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || R < K || ny % R || R + 2 * K > ny || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::StepParams p{R + 2 * K, nx, accel_row, omega, w1, w2};
  const long long plane = static_cast<long long>(ny) * nx;
  const int ext = R + 2 * K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int q = 0; q < ny / R; ++q) {
    const int base = (q * R - K + ny) % ny;  // global row of extended row 0
    const lbm::Ext<float> in{fin + static_cast<size_t>(base) * nx, plane,
                             fin + static_cast<size_t>(q) * R * nx, plane,
                             fin + static_cast<size_t>((q + 1) * R % ny) * nx, plane, K, R};
    const int d = ((accel_row - base) % ny + ny) % ny;
    const int rc = ca_inplace(in, a, obst_parts + static_cast<size_t>(q) * ext * nx, gate,
                              fout + static_cast<size_t>(q) * R * nx, plane, partials, tot_out,
                              p, d < ext ? d : -1, q > 0, grid, s);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
