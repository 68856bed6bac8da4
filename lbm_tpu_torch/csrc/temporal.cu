// K4: the trapezoid K-step temporal sweep for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/temporal_pallas.py::_sweep_kernel
// (:169; built by _build_sweep_call :437, entries make_sweep :388 and
// make_run_all :673), float32 and int16 storage (K4 and K4-i16, one
// template): one launch advances the whole grid K steps and leaves one |u|
// partial per block and level.  The levels stay float32 in shared memory,
// so int16 state is dequantized once on load and quantized once on store,
// once per sweep, as B5 does (temporal_pallas.py:38-42, :205, :366).
//
// Bound: above L2 a one-step kernel moves 9 x 4 B in and out of device
// memory per cell-step (73 B with the mask byte; K1 at 1536^2 runs at 89% of
// the copy rate).  A sweep moves the state once per K steps: per cell-step
// about (h x 37 + 37) / K bytes, h = (TH+2K)(TW+2K) / (TH TW) the halo
// factor of the loads, against about K-fold less traffic and a recompute
// factor of sum_l (TH+2K-2l)(TW+2K-2l) / (K TH TW) in cell updates from
// shared memory.  So the sweep trades device-memory bytes for shared-memory
// traffic and FP32 work, which the card has in excess at these grids.
//
// Design.  On the TPU the grid ran in order: rows were whole, only y needed
// ghosts, a block carried its top rows to the next block and block 0 rebuilt
// the wrap rows in a seam chain.  Blocks here run at once, in no order, so
// each block is an overlapped tile that needs nothing from any other:
//
// - a block owns a TH x TW output tile and loads the tile plus a K-cell
//   halo on every side (periodic wrap by index arithmetic, any ny and nx,
//   several periods if the grid is smaller than the region) into level 0;
// - level l is computed over the region shrunk by l cells per side, from
//   level l-1, ping-ponging between two shared-memory level buffers (one
//   barrier per level); level K is the tile itself and goes straight to the
//   other state buffer (the wrapper ping-pongs buffers across sweeps);
// - both axes recompute their halo: no carries and no seam chain.
//
// The driven row is injected at every level from the source cell's level
// l-1 values, wherever it falls in the region, halo included
// (lbm_pull_rows), so the TPU's accel_row >= K rule (temporal_pallas.py
// :154-161) has no counterpart.  |u| of level l counts each fluid cell of
// the block's own tile, inside the grid, once; each block reduces its cells
// in a fixed order (per thread, a warp butterfly, then the warps in order)
// into partials[sweep][l][block], and a second launch sums each row in a
// fixed order: no float atomics, so runs repeat bitwise.  A
// tile too large for shared memory makes the launch fail with an error,
// which the entry point returns.

#include "lbm_common.cuh"

namespace {

constexpr int kT = 512;  // threads per K4 block
constexpr int kWarps = kT / 32;

struct Tile {
  int K;       // depth: steps per sweep
  int th, tw;  // output tile rows and columns
  int rh, rw;  // region rows and columns: th + 2K, tw + 2K
};

Tile make_tile(int K, int th, int tw) { return Tile{K, th, tw, th + 2 * K, tw + 2 * K}; }

// Dynamic shared memory of one block: two float32 level buffers, the
// per-level per-warp |u| sums, the region's global rows and columns, wall
// bytes and driven-row flags.
size_t tile_smem(const Tile& g) {
  const size_t area = static_cast<size_t>(g.rh) * g.rw;
  return 2 * 9 * area * sizeof(float) + static_cast<size_t>(g.K) * kWarps * sizeof(float) +
         (g.rh + g.rw) * sizeof(int) + area + g.rh;
}

template <typename T>
__global__ void __launch_bounds__(kT)
    lbm_trapezoid_kernel(const T* __restrict__ fin, T* __restrict__ fout,
                         const uint8_t* __restrict__ obst, float* __restrict__ partials,
                         lbm::StepParams p, Tile g) {
  extern __shared__ float smem[];
  const int area = g.rh * g.rw;
  float* lev[2] = {smem, smem + 9 * area};
  float* wsum = smem + 18 * area;  // [level-1][warp]
  int* grow = reinterpret_cast<int*>(wsum + g.K * kWarps);
  int* gcol = grow + g.rh;
  uint8_t* wall = reinterpret_cast<uint8_t*>(gcol + g.rw);
  uint8_t* drv = wall + area;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * g.th, x0 = blockIdx.x * g.tw;
  const int nblocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;

  for (int r = tid; r < g.rh; r += kT) {
    grow[r] = lbm::lbm_wrap(y0 - g.K + r, p.ny);
    drv[r] = grow[r] == p.accel_row;
  }
  for (int c = tid; c < g.rw; c += kT) gcol[c] = lbm::lbm_wrap(x0 - g.K + c, p.nx);
  __syncthreads();

  // Level 0: the region, decoded to float32.
  for (int i = tid; i < area; i += kT) {
    const int r = i / g.rw;
    const size_t gi = static_cast<size_t>(grow[r]) * p.nx + gcol[i - r * g.rw];
    wall[i] = obst[gi] != 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) lev[0][k * area + i] = lbm::lbm_load<false>(fin + k * plane + gi, k, p);
  }
  __syncthreads();

  // Tile bounds inside the region, clipped to the grid (ragged edges).
  const int r_end = g.K + min(g.th, p.ny - y0);
  const int c_end = g.K + min(g.tw, p.nx - x0);
  for (int l = 1; l <= g.K; ++l) {
    const float* src = lev[(l - 1) & 1];
    float* dst = lev[l & 1];
    const int w = g.rw - 2 * l, h = g.rh - 2 * l;
    // i -> (i / w, i % w) by a float reciprocal: exact here, as i < 2^16
    // and (i + 0.5) / w lies at least 0.5 / w from an integer.
    const float inv_w = 1.0f / static_cast<float>(w);
    float acc = 0.0f;
    for (int i = tid; i < w * h; i += kT) {
      const int di = static_cast<int>((static_cast<float>(i) + 0.5f) * inv_w);
      const int r = l + di, c = l + (i - di * w);
      const float* rj = src + r * g.rw;
      const uint8_t* wj = wall + r * g.rw;
      float t[9], out[9];
      lbm::lbm_pull_rows(rj - g.rw, rj, rj + g.rw, area, wj - g.rw, wj, wj + g.rw, drv[r - 1],
                         drv[r], drv[r + 1], c, p, t);
      const float speed = lbm::lbm_collide(t, wj[c] != 0, p.omega, out);
      const bool own = r >= g.K && r < r_end && c >= g.K && c < c_end;
      if (own) acc = acc + speed;
      if (l < g.K) {
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * area + r * g.rw + c] = out[k];
      } else if (own) {
        const size_t o = static_cast<size_t>(y0 + r - g.K) * p.nx + (x0 + c - g.K);
#pragma unroll
        for (int k = 0; k < 9; ++k) fout[k * plane + o] = lbm::lbm_encode<T>(out[k], k, p);
      }
    }
    acc = lbm::lbm_warp_sum(acc);
    if ((tid & 31) == 0) wsum[(l - 1) * kWarps + (tid >> 5)] = acc;
    // Orders this level's writes before the next level's reads, and its
    // reads before the next level's writes.
    __syncthreads();
  }
  if (tid < g.K) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total = total + wsum[tid * kWarps + w];
    partials[static_cast<size_t>(tid) * nblocks + block] = total;
  }
}

dim3 tile_grid(int ny, int nx, const Tile& g) {
  return dim3((nx + g.tw - 1) / g.tw, (ny + g.th - 1) / g.th);
}

template <typename T>
int trapezoid_run(T* fa, T* fb, const uint8_t* obst, float* partials, float* tot_out,
                  const lbm::StepParams& p, const Tile& g, int nsweeps, int batch,
                  cudaStream_t s) {
  const size_t smem = tile_smem(g);
  cudaError_t err = cudaFuncSetAttribute(lbm_trapezoid_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tile_grid(p.ny, p.nx, g);
  const int nblocks = static_cast<int>(grid.x * grid.y);
  int done = 0;  // sweeps whose tot_u has been reduced
  for (int t = 0; t < nsweeps; ++t) {
    const T* src = (t % 2 == 0) ? fa : fb;
    T* dst = (t % 2 == 0) ? fb : fa;
    const int row = t - done;
    lbm_trapezoid_kernel<T><<<grid, kT, smem, s>>>(
        src, dst, obst, partials + static_cast<size_t>(row) * g.K * nblocks, p, g);
    if (row + 1 == batch || t + 1 == nsweeps) {
      lbm::lbm_reduce_kernel<0><<<(row + 1) * g.K, lbm::kThreads, 0, s>>>(
          partials, nblocks, tot_out + static_cast<size_t>(done) * g.K);
      done = t + 1;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of one K4 launch: the row length of its partials buffer.
int lbm_trapezoid_blocks(int ny, int nx, int K, int tile_h, int tile_w) {
  const dim3 g = tile_grid(ny, nx, make_tile(K, tile_h, tile_w));
  return static_cast<int>(g.x * g.y);
}

// Dynamic shared memory (bytes) of one K4 block.
int lbm_trapezoid_smem(int K, int tile_h, int tile_w) {
  return static_cast<int>(tile_smem(make_tile(K, tile_h, tile_w)));
}

// Advance `nsweeps` sweeps of K steps, ping-ponging fa -> fb -> fa ...: the
// state starts in fa and ends in fa for an even nsweeps, in fb for odd.
// Output tiles are tile_h x tile_w cells.  The state is float32 for i16 = 0,
// int16 with the 27 codec constants at `codec` (host memory) for i16 = 1.
// partials holds batch x K rows of lbm_trapezoid_blocks() floats; every
// `batch` sweeps (and after the last) one reduce launch turns the filled rows
// into tot_out[step].  Launches on `stream` and never synchronises.  Returns
// the first CUDA error (e.g. a tile too large for shared memory), or 0.
int lbm_trapezoid_run(void* fa, void* fb, const uint8_t* obst, float* partials,
                      float* tot_out, int ny, int nx, int accel_row, float omega, float w1,
                      float w2, int i16, const float* codec, int K, int tile_h, int tile_w,
                      int nsweeps, int batch, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || tile_h < 1 || tile_w < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const Tile g = make_tile(K, tile_h, tile_w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return trapezoid_run(static_cast<int16_t*>(fa), static_cast<int16_t*>(fb), obst, partials,
                         tot_out, p, g, nsweeps, batch, s);
  }
  return trapezoid_run(static_cast<float*>(fa), static_cast<float*>(fb), obst, partials,
                       tot_out, p, g, nsweeps, batch, s);
}

}  // extern "C"
