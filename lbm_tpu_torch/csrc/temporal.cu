// K4: the trapezoid K-step temporal sweep for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/temporal_pallas.py::_sweep_kernel
// (:169; built by _build_sweep_call :437, entries make_sweep :388 and
// make_run_all :673), float32 and int16 storage (K4 and K4-i16): one launch
// advances the whole grid K steps and leaves one |u| partial per tile and
// level.  The levels stay float32 in shared memory, so int16 state is
// dequantized once on load and quantized once on store, once per sweep, as
// B5 does (temporal_pallas.py:38-42, :205, :366).
//
// Bound: above L2 a one-step kernel moves 9 x 4 B in and out of device
// memory per cell-step (73 B with the mask byte).  A sweep moves the state
// once per K steps: per cell-step about (h x 37 + 37) / K bytes, h =
// RH RW / (TH TW) the halo factor of the loads, against a recompute factor
// of sum_l (RH-2l)(RW-2l) / (K TH TW) in cell updates from shared memory.
// At the grids it runs on the cell updates, not the bytes, set its time:
// the first design spent 280 of its 362 us per launch at 2048^2,
// K=4 in the levels and 155 in its loads when each ran alone (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md, Findings on the redesigned K4).
//
// Design.  Blocks run at once, in no order, so each tile is an overlapped
// region that needs nothing from any other tile: the TH x TW output tile
// plus a K-cell halo on every side (RH x RW cells, periodic wrap by index
// arithmetic, any ny and nx).  Level l is computed over the region shrunk
// by l cells per side from level l-1; level K is the tile and goes to the
// other state buffer (the wrapper ping-pongs buffers across sweeps).
//
// - Persistent blocks, two per SM, walk the tiles in a fixed order (tile =
//   block + j x grid).  Two region buffers take the levels in turn; level
//   K reads one and writes device memory, so a float32 tile's level 0 is
//   copied (cp.async) into the other while the previous tile's level K
//   computes, and the other block of the SM computes while this one waits.
//   The next tile's wall bytes travel in registers and are stored at the
//   tile's start.  A float32 region row that does not wrap in x is
//   contiguous in device memory and moves in 16-byte copies where the
//   address allows, else in 4-byte ones; a tile that wraps in x copies
//   element by element.  int16 is loaded with plain loads and decoded at
//   the tile's start, as the first design did: copying the raw values and
//   decoding them in a pass of their own ran 13% slower (PERF.md,
//   Findings on the redesigned K4).
// - The region is a compile-time shape (RH x RW, NT threads), so the nine
//   plane offsets and the row offsets of the pull are constants; a level's
//   cells are walked in flat order with (row, column) advanced by constant
//   steps (one integer division per level and thread); the driven row is a
//   64-bit row mask per tile (a ballot), not a byte per row.
// - The driven row is injected at every level from the source cell's level
//   l-1 values, wherever it falls in the region, halo included
//   (lbm_pull_rows), so the TPU's accel_row >= K rule (temporal_pallas.py
//   :154-161) has no counterpart.
// - |u| of level l counts each fluid cell of the tile's own output cells,
//   inside the grid, once: per thread in cell order, a warp butterfly, the
//   warps in order, into partials[l][tile] (indexed by tile, not by block,
//   so the order does not depend on scheduling); a second launch sums each
//   row in a fixed order: no float atomics, so runs repeat bitwise.
//
// K4-slab (and K4-slab-i16): the same tile loop on one shard of the exact
// communication-avoiding mode (ca), replacing B5's slab form
// (temporal_pallas.py::make_slab_sweep :535).  The shard's K ghost rows on
// each side arrive once per sweep; the tiles cover the body rows and read
// their halos from three windows (lo | body | hi, each with its own plane
// stride), so no tile row wraps in y and the K levels recompute the ghosts'
// evolution locally: the body after the sweep is K synchronous steps,
// bitwise.  The driven row is found by global row, the lower ghosts of
// shard 0 wrapping to the top of the grid; |u| counts body cells only.  The
// two forms differ only in their Src (where rows come from and go to) and
// share the tile loop and the level loop.

#include "lbm_common.cuh"

namespace {

// The regions compiled (rows, columns, threads per block): the host's
// table (ops/temporal_cuda.py REGIONS) picks one per depth.
#define LBM_TRAPEZOID_REGIONS(X) \
  X(32, 48, 512)                 \
  X(48, 64, 512)

// Dynamic shared memory of one block: two float32 region buffers, the
// per-level per-warp |u| sums and the wall bytes.
constexpr size_t region_smem(int rh, int rw, int nt, int K) {
  return 2 * 9 * static_cast<size_t>(rh) * rw * sizeof(float) +
         static_cast<size_t>(K) * (nt / 32) * sizeof(float) + static_cast<size_t>(rh) * rw;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K4's rows: a (9, ny, nx) state, plane stride ps; region row r of a tile
// at (y0, x0) is grid row (y0 - K + r) mod ny.
template <typename T>
struct GridSrc {
  const T* f;
  long long ps;
  const uint8_t* obst;
  T* out;
  long long ps_out;
  int ny;
  __device__ int row_of(int y0, int K, int r) const { return lbm::lbm_wrap(y0 - K + r, ny); }
  // Plane 0 of row rr, and the plane stride in *pstride.
  __device__ const T* row0(int rr, int nx, long long* pstride) const {
    *pstride = ps;
    return f + static_cast<size_t>(rr) * nx;
  }
  __device__ int global_row(int rr) const { return rr; }
};

// K4-slab's rows: the extended slab lo (K rows) | body (n rows) | hi (K
// rows), three windows with their own plane strides; region row r of a tile
// at body row y0 is extended row (y0 + r) mod (n + 2K) (rows a ragged last
// tile asks for past the slab wrap inside it: finite values that reach no
// output row); its global row is (row_offset - K + e) mod ny_global.
template <typename T>
struct SlabSrc {
  const T* lo;
  long long ps_lo;
  const T* body;
  long long ps;
  const T* hi;
  long long ps_hi;
  const uint8_t* obst;
  T* out;
  long long ps_out;
  int n, K, row_offset, ny_global;
  __device__ int row_of(int y0, int, int r) const { return lbm::lbm_wrap(y0 + r, n + 2 * K); }
  __device__ const T* row0(int e, int nx, long long* pstride) const {
    if (e < K) {
      *pstride = ps_lo;
      return lo + static_cast<size_t>(e) * nx;
    }
    if (e < K + n) {
      *pstride = ps;
      return body + static_cast<size_t>(e - K) * nx;
    }
    *pstride = ps_hi;
    return hi + static_cast<size_t>(e - K - n) * nx;
  }
  __device__ int global_row(int e) const { return lbm::lbm_wrap(row_offset - K + e, ny_global); }
};

template <typename T, int RH, int RW, int NT>
struct Region {
  static constexpr int kArea = RH * RW;
  static constexpr int kBuf = 9 * kArea;  // floats of a region buffer
  static constexpr int kWarps = NT / 32;
  static constexpr int kWallRegs = (kArea + NT - 1) / NT;  // wall bytes per thread
  static constexpr bool kI16 = sizeof(T) == 2;
  static_assert(RH <= 64, "the driven-row mask holds 64 rows");
  static_assert(RW % 4 == 0, "rows of whole 16-byte quads");
  static_assert(NT % 32 == 0, "whole warps");
};

// Issue the copies of float32 tile t's level 0 into buffer L (one commit
// group) and load its wall bytes into wreg (int16: the walls only; its
// state is loaded at the tile's start, load_i16).  A tile whose region
// stays inside [0, nx) in x copies each quad of a row in one 16-byte copy
// where its address is 16-byte aligned, else in four 4-byte ones; a tile
// that wraps in x copies element by element.
template <typename T, int RH, int RW, int NT, typename Src>
__device__ __forceinline__ void issue_tile(const Src& s, const lbm::StepParams& p, int K, int t,
                                           int ntx, float* L,
                                           uint8_t (&wreg)[Region<T, RH, RW, NT>::kWallRegs]) {
  using R = Region<T, RH, RW, NT>;
  const int tid = threadIdx.x;
  const int th = RH - 2 * K, tw = RW - 2 * K;
  const int y0 = (t / ntx) * th, xs = (t % ntx) * tw - K;
  const bool inx = xs >= 0 && xs + RW <= p.nx;
#pragma unroll
  for (int j = 0; j < R::kWallRegs; ++j) {
    const int i = tid + j * NT;
    if (i < R::kArea) {
      const int r = i / RW, c = i - r * RW;
      const int gc = inx ? xs + c : lbm::lbm_wrap(xs + c, p.nx);
      wreg[j] = s.obst[static_cast<size_t>(s.row_of(y0, K, r)) * p.nx + gc];
    }
  }
  if constexpr (!R::kI16) {
    long long ps;
    if (!inx) {
      for (int i = tid; i < 9 * R::kArea; i += NT) {
        const int k = i / R::kArea, rc = i - k * R::kArea, r = rc / RW;
        const T* g = s.row0(s.row_of(y0, K, r), p.nx, &ps);
        cp_async4(L + i, g + k * ps + lbm::lbm_wrap(xs + rc - r * RW, p.nx));
      }
    } else {
      for (int i = tid; i < 9 * RH * (RW / 4); i += NT) {
        const int kr = i / (RW / 4), q = i - kr * (RW / 4);
        const T* g0 = s.row0(s.row_of(y0, K, kr % RH), p.nx, &ps);
        const T* g = g0 + (kr / RH) * ps + xs + 4 * q;
        float* d = L + kr * RW + 4 * q;
        if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
          cp_async16(d, g);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(d + e, g + e);
        }
      }
    }
    cp_async_commit();
  }
}

// int16: load tile (y0, x0)'s level 0 into L, decoded to float32: nine
// plain loads per region cell (the SM's other
// block computes meanwhile).  Measured faster than copying the raw values
// and decoding them in a pass of their own (PERF.md, Findings on the
// redesigned K4).
template <typename T, int RH, int RW, int NT, typename Src>
__device__ __forceinline__ void load_i16(const Src& s, const lbm::StepParams& p, int K, int y0,
                                         int x0, float* L) {
  constexpr int AREA = RH * RW;
  const int xs = x0 - K;
  const bool inx = xs >= 0 && xs + RW <= p.nx;
  for (int i = threadIdx.x; i < AREA; i += NT) {
    const int r = i / RW, c = i - r * RW;
    long long ps;
    const T* g = s.row0(s.row_of(y0, K, r), p.nx, &ps) +
                 (inx ? xs + c : lbm::lbm_wrap(xs + c, p.nx));
#pragma unroll
    for (int k = 0; k < 9; ++k) L[k * AREA + i] = lbm::lbm_decode(g[k * ps], k, p);
  }
}

// One level of one tile: every cell of the region shrunk by l per side,
// from src into dst (l < K) or, at l = K, the tile's own cells into the
// output.  Returns this thread's |u| sum over its own cells, in cell order.
template <typename T, int RH, int RW, int NT, typename Src>
__device__ __forceinline__ float tile_level(const float* __restrict__ src, float* __restrict__ dst,
                                            const uint8_t* W, uint64_t dmask, int l, int K,
                                            int y0, int x0, int r_end, int c_end,
                                            const Src& s, const lbm::StepParams& p) {
  constexpr int AREA = RH * RW;
  const int tid = threadIdx.x;
  const int w = RW - 2 * l, n = w * (RH - 2 * l);
  const int dr = NT / w, dc = NT - dr * w;
  int r = tid / w;
  int c = l + (tid - r * w);
  r += l;
  const bool last = l == K;
  float acc = 0.0f;
  for (int i = tid; i < n; i += NT) {
    const float* rj = src + r * RW;
    const uint8_t* wj = W + r * RW;
    float t[9], out[9];
    const unsigned d3 = static_cast<unsigned>(dmask >> (r - 1)) & 7u;  // rows r-1, r, r+1
    lbm::lbm_pull_rows(rj - RW, rj, rj + RW, AREA, wj - RW, wj, wj + RW, d3 & 1u, d3 & 2u,
                       d3 & 4u, c, p, t);
    const float speed = lbm::lbm_collide(t, wj[c] != 0, p.omega, out);
    const bool own = r >= K && r < r_end && c >= K && c < c_end;
    if (own) acc = acc + speed;
    if (!last) {
      float* d = dst + r * RW + c;
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k * AREA] = out[k];
    } else if (own) {
      T* o = s.out + static_cast<size_t>(y0 + r - K) * p.nx + (x0 + c - K);
#pragma unroll
      for (int k = 0; k < 9; ++k) o[k * s.ps_out] = lbm::lbm_encode<T>(out[k], k, p);
    }
    c += dc;
    r += dr;
    if (c >= l + w) {
      c -= w;
      ++r;
    }
  }
  return acc;
}

// The tile loop of K4 and K4-slab: nrows x nx output rows (the grid, or
// the shard's body) in ntiles tiles of (RH - 2K) x (RW - 2K), ntx per row.
// Two region buffers P and Q take the levels in turn; level K reads one
// and writes device memory, so the next tile's copy lands in the other
// while level K computes (and the other block on the SM fills the gaps).
template <typename T, int RH, int RW, int NT, typename Src>
__device__ __forceinline__ void sweep_tiles(const Src& s, float* __restrict__ partials,
                                            const lbm::StepParams& p, int K, int nrows,
                                            int ntx, int ntiles) {
  using R = Region<T, RH, RW, NT>;
  constexpr int AREA = R::kArea;
  extern __shared__ float smem[];
  float* P = smem;
  float* Q = P + R::kBuf;
  float* wsum = Q + R::kBuf;  // [level-1][warp]
  uint8_t* W = reinterpret_cast<uint8_t*>(wsum + K * R::kWarps);

  const int tid = threadIdx.x, lane = tid & 31;
  const int th = RH - 2 * K, tw = RW - 2 * K;
  uint8_t wreg[R::kWallRegs];
  int t = blockIdx.x;
  int in = 0;  // the buffer the tile's copy lands in (0: P, 1: Q)
  issue_tile<T, RH, RW, NT>(s, p, K, t, ntx, P, wreg);
  for (; t < ntiles; t += gridDim.x) {
    const int y0 = (t / ntx) * th, x0 = (t % ntx) * tw;
    const int next = t + gridDim.x;
#pragma unroll
    for (int j = 0; j < R::kWallRegs; ++j)
      if (tid + j * NT < AREA) W[tid + j * NT] = wreg[j];
    // Region rows that are the driven row, as a mask (every warp alike).
    const unsigned lo_rows = __ballot_sync(
        0xffffffffu, lane < RH && s.global_row(s.row_of(y0, K, lane)) == p.accel_row);
    const unsigned hi_rows = __ballot_sync(
        0xffffffffu, lane + 32 < RH && s.global_row(s.row_of(y0, K, lane + 32)) == p.accel_row);
    const uint64_t dmask = static_cast<uint64_t>(lo_rows) | (static_cast<uint64_t>(hi_rows) << 32);
    cp_async_wait_all();
    __syncthreads();
    if constexpr (R::kI16) {
      load_i16<T, RH, RW, NT>(s, p, K, y0, x0, in ? Q : P);
      __syncthreads();
    }
    const int lev0 = in;  // the buffer of level 0
    // Tile bounds inside the region, clipped to the grid (ragged edges).
    const int r_end = K + min(th, nrows - y0);
    const int c_end = K + min(tw, p.nx - x0);
    for (int l = 1; l <= K; ++l) {
      const bool odd = (lev0 + l) & 1;  // level l goes to Q
      if (l == K && next < ntiles)  // the buffer level K leaves alone
        issue_tile<T, RH, RW, NT>(s, p, K, next, ntx, odd ? Q : P, wreg);
      float acc = tile_level<T, RH, RW, NT>(odd ? P : Q, odd ? Q : P, W, dmask, l, K, y0, x0,
                                            r_end, c_end, s, p);
      acc = lbm::lbm_warp_sum(acc);
      if (lane == 0) wsum[(l - 1) * R::kWarps + (tid >> 5)] = acc;
      // Orders this level's writes before the next level's reads, and its
      // reads before the next level's writes.
      __syncthreads();
    }
    in = (lev0 + K) & 1;
    if (tid < K) {
      float total = 0.0f;
      for (int w = 0; w < R::kWarps; ++w) total = total + wsum[tid * R::kWarps + w];
      partials[static_cast<size_t>(tid) * ntiles + t] = total;
    }
  }
  cp_async_wait_all();
}

template <typename T, int RH, int RW, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
    lbm_trapezoid_kernel(GridSrc<T> s, float* __restrict__ partials, lbm::StepParams p, int K,
                         int ntx, int ntiles) {
  sweep_tiles<T, RH, RW, NT>(s, partials, p, K, p.ny, ntx, ntiles);
}

template <typename T, int RH, int RW, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
    lbm_trapezoid_slab_kernel(SlabSrc<T> s, float* __restrict__ partials, lbm::StepParams p,
                              int K, int ntx, int ntiles) {
  sweep_tiles<T, RH, RW, NT>(s, partials, p, K, p.ny, ntx, ntiles);
}

struct Geometry {
  int K, th, tw, rh, rw;  // depth, output tile, region
  int ntx, ntiles;        // tiles per row, tiles
};

Geometry make_geometry(int nrows, int nx, int K, int th, int tw) {
  const int ntx = (nx + tw - 1) / tw;
  return Geometry{K, th, tw, th + 2 * K, tw + 2 * K, ntx, ntx * ((nrows + th - 1) / th)};
}

// Threads per block of a compiled region, or 0.
int region_threads(int rh, int rw) {
#define LBM_REGION_NT(RH, RW, NT) \
  if (rh == RH && rw == RW) return NT;
  LBM_TRAPEZOID_REGIONS(LBM_REGION_NT)
#undef LBM_REGION_NT
  return 0;
}

// Launch one sweep of a compiled region on its persistent grid.
template <typename T, int RH, int RW, int NT, typename Src, typename Kernel>
cudaError_t launch_region(Kernel kernel, const Src& s, float* partials,
                          const lbm::StepParams& p, const Geometry& g, cudaStream_t st) {
  const size_t smem = region_smem(RH, RW, NT, g.K);
  int blocks = 0;
  const cudaError_t err = lbm::persistent_blocks<NT>(kernel, smem, g.ntiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, st>>>(s, partials, p, g.K, g.ntx, g.ntiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grid(const GridSrc<T>& s, float* partials, const lbm::StepParams& p,
                        const Geometry& g, cudaStream_t st) {
#define LBM_REGION_GRID(RH, RW, NT)                                                           \
  if (g.rh == RH && g.rw == RW)                                                               \
    return launch_region<T, RH, RW, NT>(lbm_trapezoid_kernel<T, RH, RW, NT>, s, partials, p, \
                                        g, st);
  LBM_TRAPEZOID_REGIONS(LBM_REGION_GRID)
#undef LBM_REGION_GRID
  return cudaErrorInvalidValue;  // no kernel for this region
}

template <typename T>
cudaError_t launch_slab(const SlabSrc<T>& s, float* partials, const lbm::StepParams& p,
                        const Geometry& g, cudaStream_t st) {
#define LBM_REGION_SLAB(RH, RW, NT)                                                    \
  if (g.rh == RH && g.rw == RW)                                                        \
    return launch_region<T, RH, RW, NT>(lbm_trapezoid_slab_kernel<T, RH, RW, NT>, s, \
                                        partials, p, g, st);
  LBM_TRAPEZOID_REGIONS(LBM_REGION_SLAB)
#undef LBM_REGION_SLAB
  return cudaErrorInvalidValue;
}

template <typename T>
int trapezoid_run(T* fa, T* fb, const uint8_t* obst, float* partials, float* tot_out,
                  const lbm::StepParams& p, const Geometry& g, int nsweeps, int batch,
                  cudaStream_t st) {
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  int done = 0;  // sweeps whose tot_u has been reduced
  for (int t = 0; t < nsweeps; ++t) {
    const GridSrc<T> s{(t % 2 == 0) ? fa : fb, plane, obst, (t % 2 == 0) ? fb : fa, plane, p.ny};
    const int row = t - done;
    cudaError_t err =
        launch_grid<T>(s, partials + static_cast<size_t>(row) * g.K * g.ntiles, p, g, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (row + 1 == batch || t + 1 == nsweeps) {
      lbm::lbm_reduce_kernel<0><<<(row + 1) * g.K, lbm::kThreads, 0, st>>>(
          partials, g.ntiles, tot_out + static_cast<size_t>(done) * g.K);
      done = t + 1;
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// One K4-slab sweep of a shard and its |u| reduction: two launches.
template <typename T>
int trapezoid_slab(const SlabSrc<T>& s, float* partials, float* tot_out,
                   const lbm::StepParams& p, const Geometry& g, cudaStream_t st) {
  cudaError_t err = launch_slab<T>(s, partials, p, g, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::lbm_reduce_kernel<0><<<g.K, lbm::kThreads, 0, st>>>(partials, g.ntiles, tot_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tiles of one K4 or K4-slab launch on nrows x nx output cells: the row
// length of its partials buffer.
int lbm_trapezoid_blocks(int nrows, int nx, int K, int tile_h, int tile_w) {
  return make_geometry(nrows, nx, K, tile_h, tile_w).ntiles;
}

// Blocks of the persistent grid of one K4 launch of `ntiles` tiles on the
// current device (K4-slab's is the same), or -1 for a region not compiled
// or an error.
int lbm_trapezoid_grid(int K, int tile_h, int tile_w, int ntiles) {
  const int rh = tile_h + 2 * K, rw = tile_w + 2 * K;
  int blocks = -1;
#define LBM_REGION_BLOCKS(RH, RW, NT)                                            \
  if (rh == RH && rw == RW &&                                                    \
      lbm::persistent_blocks<NT>(lbm_trapezoid_kernel<float, RH, RW, NT>,        \
                                 region_smem(RH, RW, NT, K), ntiles, &blocks) != \
          cudaSuccess)                                                           \
    return -1;
  LBM_TRAPEZOID_REGIONS(LBM_REGION_BLOCKS)
#undef LBM_REGION_BLOCKS
  return blocks;
}

// Dynamic shared memory (bytes) of one K4 block of this tile and depth
// (threads as compiled for the region; 1024 for a region not compiled).
int lbm_trapezoid_smem(int K, int tile_h, int tile_w) {
  const int rh = tile_h + 2 * K, rw = tile_w + 2 * K;
  const int nt = region_threads(rh, rw);
  return static_cast<int>(region_smem(rh, rw, nt ? nt : 1024, K));
}

// Advance `nsweeps` sweeps of K steps, ping-ponging fa -> fb -> fa ...: the
// state starts in fa and ends in fa for an even nsweeps, in fb for odd.
// Output tiles are tile_h x tile_w cells; the region (tile + 2K per axis)
// must be one that is compiled (LBM_TRAPEZOID_REGIONS), else the call
// returns cudaErrorInvalidValue.  The state is float32 for i16 = 0, int16
// with the 27 codec constants at `codec` (host memory) for i16 = 1.
// partials holds batch x K rows of lbm_trapezoid_blocks() floats; every
// `batch` sweeps (and after the last) one reduce launch turns the filled rows
// into tot_out[step].  Launches on `stream` and never synchronises.  Returns
// the first CUDA error, or 0.
int lbm_trapezoid_run(void* fa, void* fb, const uint8_t* obst, float* partials,
                      float* tot_out, int ny, int nx, int accel_row, float omega, float w1,
                      float w2, int i16, const float* codec, int K, int tile_h, int tile_w,
                      int nsweeps, int batch, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 2 || tile_h < 1 || tile_w < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const Geometry g = make_geometry(ny, nx, K, tile_h, tile_w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return trapezoid_run(static_cast<int16_t*>(fa), static_cast<int16_t*>(fb), obst, partials,
                         tot_out, p, g, nsweeps, batch, s);
  }
  return trapezoid_run(static_cast<float*>(fa), static_cast<float*>(fb), obst, partials,
                       tot_out, p, g, nsweeps, batch, s);
}

// K4-slab: advance the n body rows of one shard K steps into `out`, from
// its ghost-extended slab: lo (the K rows below), body and hi (the K rows
// above), each with its own plane stride in elements and a row stride of nx;
// obst is the (n + 2K, nx) extended obstacle slab; row_offset the global row
// of body row 0; ny_global the grid's row count (the driven row and shard
// 0's lower ghosts are found modulo it).  partials holds K rows of
// lbm_trapezoid_blocks(n, nx, K, tile_h, tile_w) floats; tot_out receives
// the K per-level sums over the body's fluid cells.  float32 or int16 state
// (i16, codec) and the region rule as lbm_trapezoid_run.  Two launches on
// `stream`, no synchronisation.  Returns the first CUDA error, or 0.
int lbm_trapezoid_slab(const void* lo, long long ps_lo, const void* body, long long ps,
                       const void* hi, long long ps_hi, const uint8_t* obst, void* out,
                       long long ps_out, float* partials, float* tot_out, int n, int nx,
                       int row_offset, int ny_global, int accel_row, float omega, float w1,
                       float w2, int i16, const float* codec, int K, int tile_h, int tile_w,
                       void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 2 || n < K || tile_h < 1 || tile_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{n, nx, accel_row, omega, w1, w2};
  const Geometry g = make_geometry(n, nx, K, tile_h, tile_w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    const SlabSrc<int16_t> src{static_cast<const int16_t*>(lo), ps_lo,
                               static_cast<const int16_t*>(body), ps,
                               static_cast<const int16_t*>(hi), ps_hi, obst,
                               static_cast<int16_t*>(out), ps_out, n, K, row_offset, ny_global};
    return trapezoid_slab<int16_t>(src, partials, tot_out, p, g, s);
  }
  const SlabSrc<float> src{static_cast<const float*>(lo), ps_lo, static_cast<const float*>(body),
                           ps, static_cast<const float*>(hi), ps_hi, obst,
                           static_cast<float*>(out), ps_out, n, K, row_offset, ny_global};
  return trapezoid_slab<float>(src, partials, tot_out, p, g, s);
}

}  // extern "C"
