// K1: the one-step fused D2Q9-BGK kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/fused_pallas.py::_step_kernel (:249),
// full-grid periodic form, float32 storage (K1, below) or int16 storage
// (K1-i16, namespace i16 further down: its own design): one launch advances
// the whole grid one step (driven-row injection, 9-way pull streaming,
// bounce-back, BGK) and leaves a |u| partial per block.  The int16 form
// dequantizes every load and quantizes every store, B1's i16 codec
// (fused_pallas.py:288-351).
//
// Bound: device-memory bytes.  Every cell-step reads 9 x 4 B and writes
// 9 x 4 B of state (9 x 2 B each way for int16), plus 1 B of mask, against
// ~160 flops, far below the card's ~20 flop/byte balance point.  The design
// therefore aims at one coalesced pass: a block covers 32 columns x 8 rows,
// each thread one cell, and every pulled row segment of every plane is read
// with consecutive threads on consecutive addresses (the +-1 column shifts
// of streaming only move the segment by one word).  Periodic wrap in both
// axes is index arithmetic, so any nx and ny are accepted (no 128-lane rule)
// and no ghost rows are assembled.  The TPU kernel carried the lower ghost
// row in VMEM between sequential grid steps; here blocks run in parallel and
// each one reads its neighbours' rows straight from device memory (through
// L1/L2).
//
// |u|: each block reduces its cells in a fixed tree into partials[step][block];
// a second kernel reduces each step's row of partials in a fixed order into
// tot_out[step].  No float atomics, so runs are deterministic.
//
// K1-slab (and K1-slab-i16): the same step on one shard of the sharded
// modes, replacing B1's slab form (fused_pallas.py::make_slab_step :581,
// the same _step_kernel with external halo rows and a runtime row offset).
// The body, each ghost row and the output are separate pointers with their
// own plane strides, so a window of a larger tensor serves as any of them:
// overlap's three sub-slabs read the shard's own edge rows as ghosts and
// write straight into the new state, with no concatenation.  x wraps by
// index arithmetic; y reads come from the ghost rows at the slab's edges
// (lbm_pull_slab).  The driven row is found by global row, ghosts included,
// as in lbm_tpu's fused_step_slab.  Bound: the same 73 (f32) / 37 (int16)
// bytes of device memory per cell-step as K1.  One launch leaves a |u|
// partial per block and a one-block launch sums them, in a fixed order, into
// the slab's tot_u (int16: one launch, its last block sums them).
//
// K1-batch: K1's kernel (its kBatch instantiation) over B instances of one
// grid in one launch, the ensemble's kernel where K2-batch would get fewer
// than 3 blocks an instance (ops/ensemble_cuda.py).
// It replaces no TPU kernel: lbm_tpu's ensemble runs the jnp step under
// jax.vmap (lbm_tpu/tools/ensemble.py::_step_traced :47, vmap :117), which XLA
// compiles into one program for all B; this is that program's step.
// Instance b is blockIdx.z: its state and mask pointers are offset per
// instance (the mask stride is 0 for a mask shared by every instance, ny x nx
// for a geometry batch), and each block takes b's omega, w1 and w2 from a
// device array (three uniform loads) into its own StepParams, so the cell
// update (lbm_pull, lbm_collide) is K1's to the bit.  The |u| partials lie
// [step][b][block] and each (step, b) row is summed by K1's reduce, so
// instance b's tot_u is bitwise a single K1 run's.  Bound: 72 bytes of
// device memory per instance-cell-step and the mask's byte per cell, once
// for a shared mask, once per instance for a geometry batch.

#include <algorithm>

#include "lbm_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = lbm::kThreads / kBlockX;  // 8

// K1 (kBatch false) and K1-batch (kBatch true: instance blockIdx.z, its
// scalars read from `scalars`, its state and mask offset, its partials a row
// of their own).  K1's instantiation has none of the batch arithmetic.
template <bool kBatch>
__global__ void __launch_bounds__(lbm::kThreads)
    lbm_step_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                    const uint8_t* __restrict__ obst, long long mask_stride,
                    const float* __restrict__ scalars, float* __restrict__ partials,
                    lbm::StepParams p) {
  __shared__ float sh[lbm::kThreads];
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  if constexpr (kBatch) {
    const int b = blockIdx.z;
    p.omega = __ldg(scalars + 3 * b);
    p.w1 = __ldg(scalars + 3 * b + 1);
    p.w2 = __ldg(scalars + 3 * b + 2);
    fin += static_cast<size_t>(b) * 9 * plane;
    fout += static_cast<size_t>(b) * 9 * plane;
    obst += b * mask_stride;
    partials += static_cast<size_t>(b) * gridDim.y * gridDim.x;
  }
  const int i = blockIdx.x * kBlockX + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  float speed = 0.0f;
  if (i < p.nx && j < p.ny) {
    float t[9], out[9];
    lbm::lbm_pull(fin, obst, j, i, p, t);
    const size_t c = static_cast<size_t>(j) * p.nx + i;
    speed = lbm::lbm_collide(t, obst[c] != 0, p.omega, out);
#pragma unroll
    for (int k = 0; k < 9; ++k) fout[k * plane + c] = lbm::lbm_encode<float>(out[k], k, p);
  }
  const float total = lbm::lbm_block_sum(speed, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(lbm::kThreads)
    lbm_slab_kernel(lbm::Slab<float> s, float* __restrict__ out, long long ps_out,
                    const uint8_t* __restrict__ obst, float* __restrict__ partials,
                    lbm::StepParams p, int n, int row_offset) {
  __shared__ float sh[lbm::kThreads];
  const int i = blockIdx.x * kBlockX + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  float speed = 0.0f;
  if (i < p.nx && j < n) {
    float t[9], o[9];
    lbm::lbm_pull_slab<false>(s, n, obst, row_offset, j, i, p, t);
    speed = lbm::lbm_collide(t, obst[static_cast<size_t>(j + 1) * p.nx + i] != 0, p.omega, o);
    float* c = out + static_cast<size_t>(j) * p.nx + i;
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k * ps_out] = lbm::lbm_encode<float>(o[k], k, p);
  }
  const float total = lbm::lbm_block_sum(speed, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

dim3 step_grid(int ny, int nx) {
  return dim3((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
}

// ---------------------------------------------------------------------------
// K1-i16 and K1-slab-i16 on Hopper.  int16 moves half of float32's bytes, so
// the one-cell-per-thread kernel above, which holds float32 near the memory
// rate, leaves int16 held by its instructions, its registers and the cost of
// each block (PERF.md Findings, the int16 one-step pair).  So:
//
// - persistent blocks (as many as fit the SMs) walk tiles of 8 rows x 64
//   columns in a fixed order, a warp a row: no block launch per tile, one
//   |u| partial per block (warp shuffles, then the 8 warp sums in order);
// - a lane takes two cells in adjacent columns: one 32-bit load per plane
//   row (a warp reads 128 contiguous bytes), the +-1 column shifts taken
//   from the neighbouring lanes by warp shuffles and, at a warp's two ends,
//   by one 16-bit load of the first / last live lane; one 32-bit store per
//   plane;
// - the codec without conversion instructions (lbm_decode_word,
//   lbm_encode_bits: bitwise the same values), the two cells one after the
//   other, at 64 registers and 4 blocks per SM (fewer registers spill);
// - a row next to the driven row takes the same path: its warp first reads
//   the injection guards of its columns from the driven row (three words,
//   shuffles for the neighbours' columns), then adds the injections to the
//   pulled values as lbm_pull does;
// - offsets of type Off: int while 9 planes (or 8 plane strides plus the
//   body) stay below 2^31 elements, as the host checks, long long beyond:
//   the same code, but long long at every size cost 1-5% (more registers,
//   spills on the 16-bit path; PERF.md Findings PR 9);
// - the slab form sums its blocks' partials in the last block to finish (a
//   ticket), so one launch makes a shard step.
// An odd nx, or a window that is not 4-byte aligned, takes the same kernel
// with two 16-bit loads and stores per plane in place of the 32-bit ones.

namespace i16 {

constexpr int kWarps = lbm::kThreads / 32;  // rows of a tile, a warp each
constexpr int kCols = 64;                   // columns of a tile
constexpr int kMinBlocks = 4;
constexpr long long kOffsetLimit = 1LL << 31;  // int offsets below it

// The three source rows of one row, warp-uniform: plane 0 of each and its
// plane stride in elements, their wall rows, and whether each is the
// driven row.
template <typename Off>
struct Rows {
  const int16_t* s;  // the row below: source of cy = +1 (speeds 2, 5, 6)
  const int16_t* j;  // the row itself (speeds 0, 1, 3)
  const int16_t* n;  // the row above: source of cy = -1 (speeds 4, 7, 8)
  Off ps_s, ps_j, ps_n;
  const uint8_t* ws;
  const uint8_t* wj;
  const uint8_t* wn;
  bool ds, dj, dn;
};

// A lane's columns: c0 its first cell (even; 0 for a lane past the row's
// end, whose values no live lane takes), c1 its second (wrapped, for an odd
// nx's last lane), cw west of c0 and ce east of c1 (wrapped); the first
// lane reads cw itself, and so does the last live lane ce.
struct Cols {
  int c0, c1, cw, ce;
  bool live0, live1, west, east;
};

__device__ __forceinline__ Cols lane_cols(int c, int nx, int lane) {
  Cols k;
  k.live0 = c < nx;
  k.live1 = c + 1 < nx;
  k.c0 = k.live0 ? c : 0;
  k.c1 = k.c0 + 1 < nx ? k.c0 + 1 : k.c0 + 1 - nx;
  k.cw = k.c0 == 0 ? nx - 1 : k.c0 - 1;
  k.ce = k.c0 + 2 < nx ? k.c0 + 2 : (k.c0 + 2 - nx < nx ? k.c0 + 2 - nx : 0);  // 0: nx = 1
  k.west = lane == 0;
  k.east = lane == 31 || k.c0 + 2 >= nx;
  return k;
}

// The word of columns (c0, c1) of plane row `row + off`.
template <bool kVec, typename Off>
__device__ __forceinline__ uint32_t load_word(const int16_t* row, Off off, const Cols& c) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const unsigned int*>(row + (off + c.c0)));
  } else {
    return static_cast<uint16_t>(__ldg(row + (off + c.c0))) |
           (static_cast<uint32_t>(static_cast<uint16_t>(__ldg(row + (off + c.c1)))) << 16);
  }
}

template <typename Off>
__device__ __forceinline__ uint32_t load_half(const int16_t* row, Off off) {
  return static_cast<uint16_t>(__ldg(row + off));
}

// The wall bytes of columns (c0, c1) of a wall row (low byte: c0).
template <bool kVec>
__device__ __forceinline__ uint32_t load_walls(const uint8_t* wall, const Cols& c) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const unsigned short*>(wall + c.c0));
  } else {
    return __ldg(wall + c.c0) | (static_cast<uint32_t>(__ldg(wall + c.c1)) << 8);
  }
}

// cx = +1 (speeds 1, 5, 8): the cells pull columns c0 - 1 and c0, the high
// half of the previous lane's word (lane 0: its own load) and the low half
// of its own.  Every lane runs the shuffle.
__device__ __forceinline__ uint32_t from_west(uint32_t w, uint32_t edge, const Cols& c) {
  const uint32_t up = __shfl_up_sync(0xffffffffu, w, 1);
  return __byte_perm(c.west ? edge << 16 : up, w, 0x5432);
}

// cx = -1 (speeds 3, 6, 7): columns c0 + 1 and c0 + 2, the high half of its
// own word and the low half of the next lane's (the last live lane: its own
// load).
__device__ __forceinline__ uint32_t from_east(uint32_t w, uint32_t edge, const Cols& c) {
  const uint32_t down = __shfl_down_sync(0xffffffffu, w, 1);
  return __byte_perm(w, c.east ? edge : down, 0x5432);
}

// The injection guards (lbm_guard) of the driven row's columns a lane's
// cells pull from: bit 0 cw, bit 1 c0, bit 2 c1, bit 3 ce.  `row` and
// `wall` are the driven row's, `ps` its plane stride.
template <bool kVec, typename Off>
__device__ __forceinline__ uint32_t lane_guards(const int16_t* row, Off ps, const uint8_t* wall,
                                                const Cols& c, const lbm::StepParams& p) {
  float f3a, f3b, f6a, f6b, f7a, f7b;
  lbm::lbm_decode_word(load_word<kVec>(row, 3 * ps, c), 3, p, &f3a, &f3b);
  lbm::lbm_decode_word(load_word<kVec>(row, 6 * ps, c), 6, p, &f6a, &f6b);
  lbm::lbm_decode_word(load_word<kVec>(row, 7 * ps, c), 7, p, &f7a, &f7b);
  const uint32_t walls = load_walls<kVec>(wall, c);
  const uint32_t g0 = lbm::lbm_guard((walls & 0xffu) == 0, f3a, f6a, f7a, p);
  const uint32_t g1 = lbm::lbm_guard((walls & 0xff00u) == 0, f3b, f6b, f7b, p);
  const uint32_t up = __shfl_up_sync(0xffffffffu, g1, 1);    // column c0 - 1
  const uint32_t down = __shfl_down_sync(0xffffffffu, g0, 1);  // column c1 + 1
  uint32_t gw = up, ge = down;
  if (c.west) {
    gw = lbm::lbm_guard(!wall[c.cw], lbm::lbm_decode(row[3 * ps + c.cw], 3, p),
                        lbm::lbm_decode(row[6 * ps + c.cw], 6, p),
                        lbm::lbm_decode(row[7 * ps + c.cw], 7, p), p);
  }
  if (c.east) {
    ge = lbm::lbm_guard(!wall[c.ce], lbm::lbm_decode(row[3 * ps + c.ce], 3, p),
                        lbm::lbm_decode(row[6 * ps + c.ce], 6, p),
                        lbm::lbm_decode(row[7 * ps + c.ce], 7, p), p);
  }
  return gw | (g0 << 1) | (g1 << 2) | (ge << 3);
}

// One cell of the pair: the half `hi` of each pulled word decoded, the
// driven row's injections (west / east: the guards of the columns its
// cx = +1 / -1 speeds pull from), the collide, and the encoded results
// (bits whose low 16 are the int16).
template <typename Off>
__device__ __forceinline__ float pair_cell(const uint32_t (&w)[9], bool hi, bool wall,
                                           const Rows<Off>& r, bool west, bool east,
                                           uint32_t (&bits)[9], const lbm::StepParams& p) {
  float t[9], o[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float lo_v, hi_v;
    lbm::lbm_decode_word(w[k], k, p, &lo_v, &hi_v);
    t[k] = hi ? hi_v : lo_v;
  }
  // Speeds 1, 3 come from the row itself; 5, 6 from the row below; 7, 8
  // from the row above (lbm_pull's order of operations).
  if (r.dj) {
    t[1] = t[1] + (west ? p.w1 : 0.0f);
    t[3] = t[3] - (east ? p.w1 : 0.0f);
  }
  if (r.ds) {
    t[5] = t[5] + (west ? p.w2 : 0.0f);
    t[6] = t[6] - (east ? p.w2 : 0.0f);
  }
  if (r.dn) {
    t[7] = t[7] - (east ? p.w2 : 0.0f);
    t[8] = t[8] + (west ? p.w2 : 0.0f);
  }
  const float speed = lbm::lbm_collide(t, wall, p.omega, o);
#pragma unroll
  for (int k = 0; k < 9; ++k) bits[k] = lbm::lbm_encode_bits(o[k], k, p);
  return speed;
}

// The lane's two cells of one row into `out` (plane 0 of the row, plane
// stride ps_out).  Returns their |u|, live cells only, c0 first.
template <bool kVec, typename Off>
__device__ __forceinline__ float row_cells(const Rows<Off>& r, const Cols& c, int16_t* out,
                                           Off ps_out, const lbm::StepParams& p) {
  uint32_t guards = 0;
  if (r.ds || r.dj || r.dn) {  // warp-uniform: a row next to the driven row, or it
    guards = r.dj ? lane_guards<kVec>(r.j, r.ps_j, r.wj, c, p)
                  : (r.ds ? lane_guards<kVec>(r.s, r.ps_s, r.ws, c, p)
                          : lane_guards<kVec>(r.n, r.ps_n, r.wn, c, p));
  }
  uint32_t w[9];  // plane k's word of the row its speed is pulled from
  w[0] = load_word<kVec>(r.j, 0 * r.ps_j, c);
  w[1] = load_word<kVec>(r.j, 1 * r.ps_j, c);
  w[2] = load_word<kVec>(r.s, 2 * r.ps_s, c);
  w[3] = load_word<kVec>(r.j, 3 * r.ps_j, c);
  w[4] = load_word<kVec>(r.n, 4 * r.ps_n, c);
  w[5] = load_word<kVec>(r.s, 5 * r.ps_s, c);
  w[6] = load_word<kVec>(r.s, 6 * r.ps_s, c);
  w[7] = load_word<kVec>(r.n, 7 * r.ps_n, c);
  w[8] = load_word<kVec>(r.n, 8 * r.ps_n, c);
  uint32_t e1 = 0, e5 = 0, e8 = 0, e3 = 0, e6 = 0, e7 = 0;
  if (c.west) {
    e1 = load_half(r.j, 1 * r.ps_j + c.cw);
    e5 = load_half(r.s, 5 * r.ps_s + c.cw);
    e8 = load_half(r.n, 8 * r.ps_n + c.cw);
  }
  if (c.east) {
    e3 = load_half(r.j, 3 * r.ps_j + c.ce);
    e6 = load_half(r.s, 6 * r.ps_s + c.ce);
    e7 = load_half(r.n, 7 * r.ps_n + c.ce);
  }
  const uint32_t wall = load_walls<kVec>(r.wj, c);
  w[1] = from_west(w[1], e1, c);
  w[5] = from_west(w[5], e5, c);
  w[8] = from_west(w[8], e8, c);
  w[3] = from_east(w[3], e3, c);
  w[6] = from_east(w[6], e6, c);
  w[7] = from_east(w[7], e7, c);
  uint32_t a[9], b[9];
  const float sa = pair_cell(w, false, (wall & 0xffu) != 0, r, guards & 1u, guards & 4u, a, p);
  const float sb = pair_cell(w, true, (wall & 0xff00u) != 0, r, guards & 2u, guards & 8u, b, p);
  if constexpr (kVec) {
    if (c.live0) {  // and so c0 + 1 (nx even)
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        *reinterpret_cast<unsigned int*>(out + (k * ps_out + c.c0)) =
            __byte_perm(a[k], b[k], 0x5410);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (c.live0) out[k * ps_out + c.c0] = static_cast<int16_t>(a[k]);
      if (c.live1) out[k * ps_out + c.c0 + 1] = static_cast<int16_t>(b[k]);
    }
  }
  return (c.live0 ? sa : 0.0f) + (c.live1 ? sb : 0.0f);
}

// The tiles of an n-row state, walked by the grid's blocks in a fixed
// order (block b: tiles b, b + G, ...); rows_of(j) gives row j's sources.
// Returns the lane's |u| sum, tile after tile.
template <bool kVec, typename Off, typename RowsOf>
__device__ __forceinline__ float walk_tiles(RowsOf rows_of, int n, int16_t* out, Off ps_out,
                                            const lbm::StepParams& p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nx = p.nx;
  const int tiles_x = (nx + kCols - 1) / kCols;
  const int tiles = tiles_x * ((n + kWarps - 1) / kWarps);
  float speed = 0.0f;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int ty = t / tiles_x;
    const int j = ty * kWarps + warp;
    if (j >= n) continue;  // warp-uniform
    const Cols c = lane_cols((t - ty * tiles_x) * kCols + 2 * lane, nx, lane);
    speed = speed + row_cells<kVec>(rows_of(j), c, out + static_cast<Off>(j) * nx, ps_out, p);
  }
  return speed;
}

// The block's |u| partial: warp sums by shuffles, then warp 0's eight in
// order (fixed grouping: deterministic, no atomics).
__device__ __forceinline__ void block_partial(float speed, float* sh, float* partial) {
  const float w = lbm::lbm_warp_sum(speed);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total = total + sh[k];
    *partial = total;
  }
}

// K1-i16: one step of the whole grid, both axes periodic.
template <bool kVec, typename Off>
__global__ void __launch_bounds__(lbm::kThreads, kMinBlocks)
    step_kernel(const int16_t* __restrict__ fin, int16_t* __restrict__ fout,
                const uint8_t* __restrict__ obst, float* __restrict__ partials,
                lbm::StepParams p) {
  __shared__ float sh[kWarps];
  const int nx = p.nx;
  const Off plane = static_cast<Off>(p.ny) * nx;
  const float speed = walk_tiles<kVec>(
      [&](int j) {
        const Off js = j == 0 ? p.ny - 1 : j - 1;
        const Off jn = j + 1 == p.ny ? 0 : j + 1;
        const Off jj = j;
        return Rows<Off>{fin + js * nx, fin + jj * nx, fin + jn * nx, plane, plane, plane,
                         obst + js * nx, obst + jj * nx, obst + jn * nx,
                         js == p.accel_row, j == p.accel_row, jn == p.accel_row};
      },
      p.ny, fout, plane, p);
  block_partial(speed, sh, partials + blockIdx.x);
}

// K1-slab-i16: one step of the n body rows of a shard; the rows below row 0
// and above row n - 1 are the ghost windows lo and hi (each plane stride
// its own).  partials[0] is the ticket counter (zero between launches), the
// blocks' partials follow; the last block to finish sums them in block
// order into *tot_out and resets the counter.  The plane strides are given
// as long long whatever Off is.
template <bool kVec, typename Off>
__global__ void __launch_bounds__(lbm::kThreads, kMinBlocks)
    slab_kernel(const int16_t* __restrict__ body, long long ps_body,
                const int16_t* __restrict__ lo, long long ps_lo,
                const int16_t* __restrict__ hi, long long ps_hi, int16_t* __restrict__ out,
                long long ps_out, const uint8_t* __restrict__ obst,
                float* __restrict__ partials, float* __restrict__ tot_out, lbm::StepParams p,
                int n, int row_offset) {
  __shared__ float sh[lbm::kThreads];
  __shared__ bool last;
  const int nx = p.nx;
  const Off ps = static_cast<Off>(ps_body), pl = static_cast<Off>(ps_lo),
            ph = static_cast<Off>(ps_hi);
  const float speed = walk_tiles<kVec>(
      [&](int j) {
        const int g = row_offset + j;  // global row, for the driven row
        const int16_t* own = body + static_cast<Off>(j) * nx;
        const uint8_t* wall = obst + static_cast<Off>(j + 1) * nx;  // body row j's walls
        return Rows<Off>{j == 0 ? lo : own - nx, own, j + 1 == n ? hi : own + nx,
                         j == 0 ? pl : ps, ps, j + 1 == n ? ph : ps,
                         wall - nx, wall, wall + nx,
                         g - 1 == p.accel_row, g == p.accel_row, g + 1 == p.accel_row};
      },
      n, out, static_cast<Off>(ps_out), p);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(partials);
  block_partial(speed, sh, partials + 1 + blockIdx.x);
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partial before its ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    lbm::lbm_reduce_row(partials + 1, gridDim.x, 0, tot_out, sh);
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

int tiles(int rows, int nx) {
  return ((nx + kCols - 1) / kCols) * ((rows + kWarps - 1) / kWarps);
}

bool aligned4(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 3u) == 0; }

}  // namespace i16

// nsteps launches, launch(t, row) running step t into its row of partials
// (nb instances of nblocks floats); every `batch` steps, and after the
// last, one reduce launch sums each instance's nblocks of the filled rows
// into tot_out, nb values a step.
template <typename Launch>
int step_loop(Launch launch, int nblocks, float* partials, float* tot_out, int nsteps,
              int batch, cudaStream_t s, int nb = 1) {
  int done = 0;  // steps whose tot_u has been reduced
  for (int t = 0; t < nsteps; ++t) {
    const int row = t - done;
    launch(t, partials + static_cast<size_t>(row) * nb * nblocks);
    if (row + 1 == batch || t + 1 == nsteps) {
      lbm::lbm_reduce_kernel<0><<<(row + 1) * nb, lbm::kThreads, 0, s>>>(
          partials, nblocks, tot_out + static_cast<size_t>(done) * nb);
      done = t + 1;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 where scalars is null (p's omega, w1, w2; nb = 1), else K1-batch over
// nb instances.
int step_run(float* fa, float* fb, const uint8_t* obst, long long mask_stride,
             const float* scalars, float* partials, float* tot_out, const lbm::StepParams& p,
             int nb, int nsteps, int batch, cudaStream_t s) {
  const dim3 g = step_grid(p.ny, p.nx);
  const dim3 grid(g.x, g.y, nb);
  const auto kernel = scalars ? lbm_step_kernel<true> : lbm_step_kernel<false>;
  return step_loop(
      [&](int t, float* part) {
        kernel<<<grid, dim3(kBlockX, kBlockY), 0, s>>>(t % 2 == 0 ? fa : fb,
                                                       t % 2 == 0 ? fb : fa, obst,
                                                       mask_stride, scalars, part, p);
      },
      static_cast<int>(g.x * g.y), partials, tot_out, nsteps, batch, s, nb);
}

// The K1-i16 kernel for a layout: 32-bit accesses or 16-bit, int offsets
// or long long (`wide`).
using StepKernel = void (*)(const int16_t*, int16_t*, const uint8_t*, float*, lbm::StepParams);

StepKernel step_kernel_i16(bool vec, bool wide) {
  return vec ? (wide ? i16::step_kernel<true, long long> : i16::step_kernel<true, int>)
             : (wide ? i16::step_kernel<false, long long> : i16::step_kernel<false, int>);
}

int step_run_i16(int16_t* fa, int16_t* fb, const uint8_t* obst, float* partials,
                 float* tot_out, const lbm::StepParams& p, int nsteps, int batch,
                 cudaStream_t s) {
  const bool vec = p.nx % 2 == 0 && i16::aligned4(fa) && i16::aligned4(fb);
  const StepKernel kernel = step_kernel_i16(vec, 9LL * p.ny * p.nx >= i16::kOffsetLimit);
  int blocks = 0;
  const cudaError_t err =
      lbm::persistent_blocks<lbm::kThreads>(kernel, 0, i16::tiles(p.ny, p.nx), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return step_loop(
      [&](int t, float* part) {
        kernel<<<blocks, lbm::kThreads, 0, s>>>(t % 2 == 0 ? fa : fb, t % 2 == 0 ? fb : fa, obst,
                                                part, p);
      },
      blocks, partials, tot_out, nsteps, batch, s);
}

int slab_step(const void* body, long long ps, const void* lo, long long ps_lo, const void* hi,
              long long ps_hi, const uint8_t* obst, void* out, long long ps_out,
              float* partials, float* tot_out, int n, int row_offset,
              const lbm::StepParams& p, cudaStream_t s) {
  const lbm::Slab<float> slab{static_cast<const float*>(body), ps,
                              static_cast<const float*>(lo),   ps_lo,
                              static_cast<const float*>(hi),   ps_hi};
  const dim3 grid = step_grid(n, p.nx);
  lbm_slab_kernel<<<grid, dim3(kBlockX, kBlockY), 0, s>>>(slab, static_cast<float*>(out), ps_out,
                                                          obst, partials, p, n, row_offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::lbm_reduce_kernel<0><<<1, lbm::kThreads, 0, s>>>(partials,
                                                        static_cast<int>(grid.x * grid.y),
                                                        tot_out);
  return static_cast<int>(cudaGetLastError());
}

// The K1-slab-i16 kernel for a layout, as step_kernel_i16().
using SlabKernel = void (*)(const int16_t*, long long, const int16_t*, long long,
                            const int16_t*, long long, int16_t*, long long, const uint8_t*,
                            float*, float*, lbm::StepParams, int, int);

SlabKernel slab_kernel_i16(bool vec, bool wide) {
  return vec ? (wide ? i16::slab_kernel<true, long long> : i16::slab_kernel<true, int>)
             : (wide ? i16::slab_kernel<false, long long> : i16::slab_kernel<false, int>);
}

int slab_step_i16(const void* body, long long ps, const void* lo, long long ps_lo,
                  const void* hi, long long ps_hi, const uint8_t* obst, void* out,
                  long long ps_out, float* partials, float* tot_out, int n, int row_offset,
                  const lbm::StepParams& p, cudaStream_t s) {
  const long long widest = std::max(std::max(ps, ps_lo), std::max(ps_hi, ps_out));
  const bool vec = p.nx % 2 == 0 && (ps | ps_lo | ps_hi | ps_out) % 2 == 0 &&
                   i16::aligned4(body) && i16::aligned4(lo) && i16::aligned4(hi) &&
                   i16::aligned4(out);
  const SlabKernel kernel =
      slab_kernel_i16(vec, 8 * widest + static_cast<long long>(n) * p.nx >= i16::kOffsetLimit);
  int blocks = 0;
  const cudaError_t err =
      lbm::persistent_blocks<lbm::kThreads>(kernel, 0, i16::tiles(n, p.nx), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, lbm::kThreads, 0, s>>>(
      static_cast<const int16_t*>(body), ps, static_cast<const int16_t*>(lo), ps_lo,
      static_cast<const int16_t*>(hi), ps_hi, static_cast<int16_t*>(out), ps_out, obst, partials,
      tot_out, p, n, row_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Text of a cudaError_t returned by an entry point.
const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of one step launch: the row length of the partials buffer (the
// float32 kernel's count, which bounds the int16 kernel's).
int lbm_step_blocks(int ny, int nx) {
  const dim3 g = step_grid(ny, nx);
  return static_cast<int>(g.x * g.y);
}

// Advance `nsteps` steps, ping-ponging fa -> fb -> fa ...: the state starts
// in fa and ends in fa for even nsteps, in fb for odd.  The state is float32
// for i16 = 0, int16 with the 27 codec constants at `codec` (host memory,
// lbm::Codec order) for i16 = 1.  partials holds `batch` rows of
// lbm_step_blocks() floats; every `batch` steps (and after the last) one
// reduce launch turns the filled rows into tot_out[step].  Launches on
// `stream` and never synchronises.  Returns cudaGetLastError().
int lbm_step_run(void* fa, void* fb, const uint8_t* obst, float* partials,
                 float* tot_out, int ny, int nx, int accel_row, float omega,
                 float w1, float w2, int i16, const float* codec, int nsteps,
                 int batch, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return step_run_i16(static_cast<int16_t*>(fa), static_cast<int16_t*>(fb), obst, partials,
                        tot_out, p, nsteps, batch, s);
  }
  return step_run(static_cast<float*>(fa), static_cast<float*>(fb), obst, 0, nullptr,
                  partials, tot_out, p, 1, nsteps, batch, s);
}

// K1-batch: advance nb instances of an ny x nx float32 grid `nsteps` steps,
// ping-ponging fa -> fb -> fa ... as lbm_step_run (instance b's state at
// b * 9 * ny * nx of each buffer).  obst: instance b's mask at
// b * mask_stride bytes (0: one mask for all).  scalars: nb x (omega, w1,
// w2) float32 on the device.  partials holds `batch` rows of nb x
// lbm_step_blocks() floats; tot_out receives nsteps x nb sums, step-major.
// nb must not exceed 65535 (the grid's z extent).  On `stream`, no
// synchronisation.  Returns cudaGetLastError().
int lbm_step_batch_run(void* fa, void* fb, const uint8_t* obst, long long mask_stride,
                       const float* scalars, float* partials, float* tot_out, int ny, int nx,
                       int accel_row, int nb, int nsteps, int batch, void* stream,
                       int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const lbm::StepParams p{ny, nx, accel_row, 0.0f, 0.0f, 0.0f};
  if (scalars == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return step_run(static_cast<float*>(fa), static_cast<float*>(fb), obst, mask_stride, scalars,
                  partials, tot_out, p, nb, nsteps, batch, static_cast<cudaStream_t>(stream));
}

// K1-slab: advance the n body rows of one shard one step into `out`.  body,
// lo (the ghost row below), hi (the ghost row above) and out each have
// their own plane stride in elements and a row stride of nx; obst is the
// (n + 2, nx) obstacle slab with its ghost rows; row_offset is the global
// row of body row 0.  partials holds lbm_step_blocks(n, nx) + 1 floats,
// zero before the first launch: word 0 is the int16 kernel's ticket counter
// (back at zero after every launch), the blocks' partials follow.  The
// slab's tot_u is written to *tot_out.  float32 state for i16 = 0 (two
// launches: the step, then the sum of its partials), int16 with the codec
// at `codec` (host memory) for i16 = 1 (one launch).  On `stream`, no
// synchronisation.  Returns cudaGetLastError().
int lbm_slab_step(const void* body, long long ps, const void* lo, long long ps_lo,
                  const void* hi, long long ps_hi, const uint8_t* obst, void* out,
                  long long ps_out, float* partials, float* tot_out, int n, int nx,
                  int row_offset, int accel_row, float omega, float w1, float w2, int i16,
                  const float* codec, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::StepParams p{n, nx, accel_row, omega, w1, w2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return slab_step_i16(body, ps, lo, ps_lo, hi, ps_hi, obst, out, ps_out, partials, tot_out,
                         n, row_offset, p, s);
  }
  return slab_step(body, ps, lo, ps_lo, hi, ps_hi, obst, out, ps_out, partials + 1,
                          tot_out, n, row_offset, p, s);
}

}  // extern "C"
