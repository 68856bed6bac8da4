// K5: the skewed K-step temporal sweep for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/skew_pallas.py::_skew_kernel (:211;
// built by _build_sweep_call :428, entries make_pair :529 and make_run_all
// :597), float32 and int16 storage (K5 and K5-i16, one template): one launch
// advances the whole grid K steps and leaves one |u| partial per block and
// level.  The levels stay float32 in shared memory, so int16 state is
// dequantized once on load and quantized once on store, once per sweep, as
// B6 does (skew_pallas.py:249, :408, :543-547).
//
// Bound: as K4 (csrc/temporal.cu), device-memory bytes against
// shared-memory traffic and FP32 work.  Per cell-step a sweep moves about
// (hx hy x 37 + 37) / K bytes, with hx = (TW+2K)/TW and hy = (H+2K)/H the
// load overlaps of a strip and a band, against the one-step kernel's 73 B.
// Unlike K4 the rows are walked, not tiled: y has no halo recompute inside a
// band, only x (the K-column halo of the strip) and the band's warm-up.
//
// Design.  A block owns a strip of TW output columns (plus a K-column halo
// on each side, recomputed) and a band of H output rows, and walks the
// band's rows upward in one loop, which takes the place of the TPU's
// sequential grid:
//
// - walk step s loads level-0 row y0-K+s of the strip (periodic wrap by
//   index arithmetic) and computes level l at row y0-K+s-2l, for every
//   l = 1..K, with the halo shrinking one column per side per level;
// - level l at row q needs level l-1 at rows q-1, q, q+1, all computed at
//   earlier steps (a skew of 2 rows per level), so the levels of one step
//   are independent and one barrier per step is enough.  Each level keeps a
//   ring of its last 4 rows in shared memory: 3 read while the 4th is
//   written.  That is B6's 2F-row carry: every row of every level is
//   computed once per band;
// - the walk starts K rows below the band and level l becomes valid l rows
//   above that, so level K's first row is the band's first: B6's 2K-row
//   seam strip with validity growing level by level, paid once per band;
// - level K's row is written at its true position in the other state
//   buffer.  On the TPU the forward sweep left the state rotated K rows and
//   a mirrored reverse sweep undid it, only because a Pallas output block
//   must sit at a block index (skew_pallas.py:19-30).  A CUDA block writes
//   where it likes, so there is no rotation and no reverse sweep: every
//   sweep is the same forward sweep, and the wrapper ping-pongs buffers.
//
// The driven row is injected at every level from the source cell's level
// l-1 values wherever it falls, warm-up rows and halo included
// (lbm_pull_rows).  |u| of level l counts each fluid cell of the block's own
// rows and columns, inside the grid, once: per-thread sums in registers (a
// fixed cell-to-thread map, so a fixed order), a fixed-order block sum per
// level into partials[sweep][l][block] and a fixed-order second launch.
// No float atomics, so runs repeat bitwise.  A strip or band too large for
// shared memory makes the launch fail with an error, which the entry point
// returns.

#include "lbm_common.cuh"

namespace {

constexpr int kT = 256;       // threads per K5 block
constexpr int kMaxPre = 6;    // level-0 values each thread loads per walk step
constexpr int kMaxItems = 4;  // (level, column) cells each thread computes per walk step
constexpr int kRing = 4;      // rows kept per level

struct Strip {
  int K;       // depth: steps per sweep
  int tw, bh;  // output columns of a strip, output rows of a band
  int cw;      // columns held: tw + 2K
  int rows;    // rows of the band's walls: bh + 2K
};

Strip make_strip(int K, int tw, int bh) { return Strip{K, tw, bh, tw + 2 * K, bh + 2 * K}; }

// (level, column) cells of one walk step: sum over l = 1..K of cw - 2l.
int strip_items(const Strip& g) { return g.K * g.cw - g.K * (g.K + 1); }

// Dynamic shared memory of one block: K rings of float32 level rows, the
// block sum scratch, the strip's global columns, its wall bytes and
// driven-row flags.
size_t strip_smem(const Strip& g) {
  return static_cast<size_t>(g.K) * kRing * 9 * g.cw * sizeof(float) + kT * sizeof(float) +
         g.cw * sizeof(int) + static_cast<size_t>(g.rows) * g.cw + g.rows;
}

template <typename T>
__global__ void __launch_bounds__(kT)
    lbm_skew_kernel(const T* __restrict__ fin, T* __restrict__ fout,
                    const uint8_t* __restrict__ obst, float* __restrict__ partials,
                    lbm::StepParams p, Strip g) {
  extern __shared__ float smem[];
  const int K = g.K, cw = g.cw;
  const int ring_row = 9 * cw;  // floats of one level row
  float* ring = smem;           // [level 0..K-1][slot 0..3][plane][column]
  float* red = ring + static_cast<size_t>(K) * kRing * ring_row;
  int* gcol = reinterpret_cast<int*>(red + kT);
  uint8_t* wall = reinterpret_cast<uint8_t*>(gcol + cw);  // [band row][column]
  uint8_t* drv = wall + static_cast<size_t>(g.rows) * cw;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * g.bh, x0 = blockIdx.x * g.tw;
  const int nblocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;

  for (int c = tid; c < cw; c += kT) gcol[c] = lbm::lbm_wrap(x0 - K + c, p.nx);
  for (int q = tid; q < g.rows; q += kT) drv[q] = lbm::lbm_wrap(y0 - K + q, p.ny) == p.accel_row;
  __syncthreads();
  for (int i = tid; i < g.rows * cw; i += kT) {
    const int q = i / cw;
    wall[i] = obst[static_cast<size_t>(lbm::lbm_wrap(y0 - K + q, p.ny)) * p.nx + gcol[i - q * cw]] != 0;
  }

  // Rows q are counted from the band's first level-0 row, y0 - K.  Level l
  // is valid over q in [l, rows - l); level K's rows [K, K + bh) are the
  // band's, clipped to the grid.
  const int own_q_end = K + min(g.bh, p.ny - y0);
  const int own_c_end = K + min(g.tw, p.nx - x0);
  // This thread's cells of every walk step, fixed for the whole walk: item
  // j = tid + m kT of the step's (level, column) pairs, level by level;
  // l = K + 1 marks no item.  acc[m] sums |u| of item m's own cells.
  int il[kMaxItems], ic[kMaxItems];
  float acc[kMaxItems];
#pragma unroll
  for (int m = 0; m < kMaxItems; ++m) {
    int j = tid + m * kT, l = 1;
    while (l <= K && j >= cw - 2 * l) {
      j -= cw - 2 * l;
      ++l;
    }
    il[m] = l;
    ic[m] = j + l;
    acc[m] = 0.0f;
  }
  // Level-0 row q is loaded into registers during step q - 1 and stored to
  // its ring slot at step q, so its loads have a whole step to land.
  T pre[kMaxPre];
  auto load_row = [&](int q) {
    if (q >= g.rows) return;
    const size_t grow = static_cast<size_t>(lbm::lbm_wrap(y0 - K + q, p.ny)) * p.nx;
#pragma unroll
    for (int m = 0; m < kMaxPre; ++m) {
      const int j = tid + m * kT;
      if (j < ring_row) {
        const int k = j / cw;
        pre[m] = fin[k * plane + grow + gcol[j - k * cw]];
      }
    }
  };
  load_row(0);
  const int steps = g.bh + 3 * K;
  for (int s = 0; s < steps; ++s) {
    if (s < g.rows) {
      float* row0 = ring + (s & 3) * ring_row;
#pragma unroll
      for (int m = 0; m < kMaxPre; ++m) {
        const int j = tid + m * kT;
        if (j < ring_row) row0[j] = lbm::lbm_decode(pre[m], j / cw, p);
      }
    }
    load_row(s + 1);

#pragma unroll
    for (int m = 0; m < kMaxItems; ++m) {
      const int l = il[m], c = ic[m];
      const int q = s - 2 * l;
      if (l > K || q < l || q >= g.rows - l) continue;
      const float* lower = ring + static_cast<size_t>(l - 1) * kRing * ring_row;
      const uint8_t* wj = wall + q * cw;
      float t[9], out[9];
      lbm::lbm_pull_rows(lower + ((q - 1) & 3) * ring_row, lower + (q & 3) * ring_row,
                         lower + ((q + 1) & 3) * ring_row, cw, wj - cw, wj, wj + cw,
                         drv[q - 1], drv[q], drv[q + 1], c, p, t);
      const float speed = lbm::lbm_collide(t, wj[c] != 0, p.omega, out);
      const bool own = q >= K && q < own_q_end && c >= K && c < own_c_end;
      if (own) acc[m] = acc[m] + speed;
      if (l < K) {
        float* dst = ring + (static_cast<size_t>(l) * kRing + (q & 3)) * ring_row;
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * cw + c] = out[k];
      } else if (own) {
        const size_t o = static_cast<size_t>(y0 + q - K) * p.nx + (x0 + c - K);
#pragma unroll
        for (int k = 0; k < 9; ++k) fout[k * plane + o] = lbm::lbm_encode<T>(out[k], k, p);
      }
    }

    __syncthreads();
  }

  // Per level: the items of level l are j in [first, first + cw - 2l);
  // sum them in a fixed order (strided per thread, then the block tree).
  // The rings are free now and hold the item sums.
#pragma unroll
  for (int m = 0; m < kMaxItems; ++m) {
    if (il[m] <= K) ring[tid + m * kT] = acc[m];
  }
  __syncthreads();
  for (int l = 1, first = 0; l <= K; first += cw - 2 * l, ++l) {
    float v = 0.0f;
    for (int j = first + tid; j < first + cw - 2 * l; j += kT) v = v + ring[j];
    const float total = lbm::lbm_block_sum<kT>(v, red);
    if (tid == 0) partials[static_cast<size_t>(l - 1) * nblocks + block] = total;
  }
}

dim3 strip_grid(int ny, int nx, const Strip& g) {
  return dim3((nx + g.tw - 1) / g.tw, (ny + g.bh - 1) / g.bh);
}

template <typename T>
int skew_run(T* fa, T* fb, const uint8_t* obst, float* partials, float* tot_out,
             const lbm::StepParams& p, const Strip& g, int nsweeps, int batch, cudaStream_t s) {
  const size_t smem = strip_smem(g);
  cudaError_t err = cudaFuncSetAttribute(lbm_skew_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = strip_grid(p.ny, p.nx, g);
  const int nblocks = static_cast<int>(grid.x * grid.y);
  int done = 0;  // sweeps whose tot_u has been reduced
  for (int t = 0; t < nsweeps; ++t) {
    const T* src = (t % 2 == 0) ? fa : fb;
    T* dst = (t % 2 == 0) ? fb : fa;
    const int row = t - done;
    lbm_skew_kernel<T><<<grid, kT, smem, s>>>(
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

// Blocks of one K5 launch: the row length of its partials buffer.
int lbm_skew_blocks(int ny, int nx, int K, int strip_w, int band_h) {
  const dim3 g = strip_grid(ny, nx, make_strip(K, strip_w, band_h));
  return static_cast<int>(g.x * g.y);
}

// Dynamic shared memory (bytes) of one K5 block, or -1 for a strip wider
// than a walk step's level-0 loads or cells cover.
int lbm_skew_smem(int K, int strip_w, int band_h) {
  const Strip g = make_strip(K, strip_w, band_h);
  if (9 * g.cw > kT * kMaxPre || strip_items(g) > kT * kMaxItems) return -1;
  return static_cast<int>(strip_smem(g));
}

// Advance `nsweeps` sweeps of K steps, ping-ponging fa -> fb -> fa ... as
// lbm_trapezoid_run does, with strips of strip_w output columns and bands of
// band_h output rows.  Same state, codec, partials and tot_out conventions
// (partials holds batch x K rows of lbm_skew_blocks() floats).  Returns the
// first CUDA error, cudaErrorInvalidValue for a strip lbm_skew_smem()
// refuses, or 0.
int lbm_skew_run(void* fa, void* fb, const uint8_t* obst, float* partials, float* tot_out,
                 int ny, int nx, int accel_row, float omega, float w1, float w2, int i16,
                 const float* codec, int K, int strip_w, int band_h, int nsweeps, int batch,
                 void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || strip_w < 1 || band_h < 1 || batch < 1 ||
      lbm_skew_smem(K, strip_w, band_h) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const Strip g = make_strip(K, strip_w, band_h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return skew_run(static_cast<int16_t*>(fa), static_cast<int16_t*>(fb), obst, partials,
                    tot_out, p, g, nsweeps, batch, s);
  }
  return skew_run(static_cast<float*>(fa), static_cast<float*>(fb), obst, partials, tot_out, p,
                  g, nsweeps, batch, s);
}

}  // extern "C"
