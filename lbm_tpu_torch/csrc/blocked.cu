// K10: the two-copy row-block persistent kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_blocked_chunk_kernel
// (:480, built by make_chunk_runner :766 -> pallas_call :882): `chunk` steps in
// one launch, the state ping-ponging between two whole-grid copies, each step
// walked as row blocks of B rows that read the periodic shifted windows
// [r0 - cy, r0 + B - cy) of the source, with the driven row's accel-adjusted
// values, and the step's |u| summed in B4's grouping: per column, the B rows
// of a row block in row order; then the row blocks in block order; then one
// fixed-order sum over the columns.
//
// Bound: 9 x 4 B read + 9 x 4 B written per cell-step, from L2 while both
// copies fit there (to 768^2; at 1024^2 they take 72 MiB and stream from
// HBM), plus each step's wait for the neighbouring tiles and the (ny / B,
// nx) column partials.  On the TPU both copies sat in VMEM and Mosaic walked
// the row blocks one after another.
//
// Design (the two-copy neighbour-wait machinery of K2, two_copy.cuh, with
// B4's grouping).  The unit of work is a warp tile: B rows x 32 columns, a
// lane a column, the lane walking the tile's rows two at a time (the 18
// loads of both cells issued before the first collide) and adding each
// row's |u| to its column's partial in row order, so the (row block,
// column) partial of B4's grouping comes out of one register, with no
// shared memory and no barrier of the block; each load and store of a warp
// is one 128-byte line of a plane.  That gives ny / B x nx lanes, too few
// to fill the card below 1024^2 (16384 at 512^2, B = 16), so where a split
// keeps within kTargetWarps warps the host gives a tile W = 2, 4 or 8 warps
// of one block (warps_per_tile): warp g walks rows [g R, g R + R), R = B /
// W, and keeps their |u| in shared memory; after the group's named barrier
// (bar.sync on the tile's W warps, the whole block only where W = 8) warp
// 0 adds the B rows in row order.  (Splitting the rows over lane groups of
// one warp instead, with shuffles, cost whole lines: a warp's access fell
// on 2 or 4 rows, and the kernel's memory part ran at 2.2 TB/s at 512^2;
// PERF.md, Findings.)  Tiles are spread evenly over the groups of one
// cooperative launch (every warp resident).  A tile's step t + 1
// waits only for the 3 x 3 tiles around it (y and x wrapping) to finish
// step t, on their step counters (one 128-byte line each, as two::
// kCounterWords): they wrote the rows it reads (read after write) and read
// the cells it overwrites (write after read), the one relation both ways.
// The column pass runs on warps of its own, one per 32 columns: for step t
// it waits for the tiles of its columns, sums their partials in block order
// and publishes its own counter; the partials sit in a ring of kPartSlots
// slots, and a tile waits for its column pass of step t - kPartSlots before
// it overwrites that slot.  After the last step the blocks that sum a step
// wait for every column pass and sum the columns in lbm_reduce_row's fixed
// order.  No grid barrier, no float atomics: a run repeats bitwise.  The
// counters are launch-relative: the wrapper zeroes them before each launch.
//
// The driven row: a pulled value from the driven row carries its source
// cell's guarded injection, the guard recomputed from the source cell in
// the copy being read, as K1 and K2 do (B4's once-per-step adjusted row
// gives the same values).  Rows and columns come from counters (one divide
// per tile step, none per cell); offsets are 32-bit where 9 planes stay
// below 2^31 elements, long long beyond (one template, chosen on the host).
//
// The earlier design (tiles of B x 256 / B cells, one cell a thread,
// two block barriers a tile and a grid barrier a step) took 8252 us a
// 256-step launch at 1024^2, B = 16 (PERF.md §6).
//
// Every state and partial load goes through L2 only (__ldcg): other warps
// wrote them in the same launch.

#include "two_copy.cuh"

namespace {

using lbm::two::kCounterWords;

constexpr int kWarps = lbm::kThreads / 32;
// Slots of the ring of column partials (ops/blocked_cuda.py PART_SLOTS).
constexpr int kPartSlots = 4;
// The most tile warps a split of a tile's rows over warps may give
// (warps_per_tile; tests/test_torch_blocked.py models it): about the 4224
// warps an H100 holds, less the column passes.
constexpr int kTargetWarps = 4096;
// The most rows of a tile split over warps (the groups' shared speeds).
constexpr int kMaxGroupRows = 16;

// Spin until *c counts at least `count` (acquire); traps after kMaxPolls,
// as aa::band_wait.
__device__ __forceinline__ void poll(const unsigned* c, unsigned count) {
  for (unsigned polls = 0; static_cast<int>(lbm::aa::ld_acquire(c) - count) < 0; ++polls) {
    if (polls == lbm::aa::kMaxPolls) __trap();
  }
}

// The guarded injection of the source cell at offset x of copy a: w, or
// 0.0f where the guard is false.
template <typename Idx>
__device__ __forceinline__ float gate(const float* a, Idx plane, const uint8_t* wall, Idx x,
                                      float w, const lbm::StepParams& p) {
  return lbm::lbm_guard(!wall[x], __ldcg(a + (3 * plane + x)), __ldcg(a + (6 * plane + x)),
                        __ldcg(a + (7 * plane + x)), p)
             ? w
             : 0.0f;
}

// A cell's offsets: its row (rj), the rows it pulls from (rs: cy = +1, the
// row below; rn: cy = -1, the row above), and its columns.
template <typename Idx>
struct Cell {
  Idx rs, rj, rn;
  int i, iw, ie;
};

// The pull of streaming from copy a, t[k] = a[k][x - c_k], with the driven
// row's injection (arow: its offset, or -1) in lbm_pull()'s order: loads
// first (load), injection after (inject), so that a round's loads are all
// in flight before its first collide.
template <typename Idx>
__device__ __forceinline__ void load(const float* a, Idx plane, const Cell<Idx>& c, float t[9]) {
  const Idx row[3] = {c.rs, c.rj, c.rn};  // source row of cy = +1, 0, -1
  const int col[3] = {c.iw, c.i, c.ie};   // source column of cx = +1, 0, -1
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    t[k] = __ldcg(a + (k * plane + row[1 - lbm::aa::cy(k)] + col[1 - lbm::aa::cx(k)]));
  }
}

template <typename Idx>
__device__ __forceinline__ void inject(float t[9], const float* a, Idx plane,
                                       const uint8_t* wall, const Cell<Idx>& c, Idx arow,
                                       const lbm::StepParams& p) {
  if (c.rj == arow) {
    t[1] = t[1] + gate(a, plane, wall, c.rj + c.iw, p.w1, p);
    t[3] = t[3] - gate(a, plane, wall, c.rj + c.ie, p.w1, p);
  }
  if (c.rs == arow) {
    t[5] = t[5] + gate(a, plane, wall, c.rs + c.iw, p.w2, p);
    t[6] = t[6] - gate(a, plane, wall, c.rs + c.ie, p.w2, p);
  }
  if (c.rn == arow) {
    t[7] = t[7] - gate(a, plane, wall, c.rn + c.ie, p.w2, p);
    t[8] = t[8] + gate(a, plane, wall, c.rn + c.iw, p.w2, p);
  }
}

// One cell-pair round of a lane: rows j (and j + 1 where `two`) of column
// i, the 18 loads issued before the first collide; the new values stored
// to d, the rows' |u| returned in s0, s1.
template <typename Idx>
__device__ __forceinline__ void pair(const float* a, float* d, Idx plane,
                                     const uint8_t* __restrict__ obst, int j, bool two, int i,
                                     int iw, int ie, int ny, int nx, Idx arow,
                                     const lbm::StepParams& p, float* s0, float* s1) {
  Cell<Idx> c[2];
  c[0] = {(j == 0 ? ny - 1 : j - 1) * static_cast<Idx>(nx), static_cast<Idx>(j) * nx,
          (j + 1 == ny ? 0 : j + 1) * static_cast<Idx>(nx), i, iw, ie};
  c[1] = {c[0].rj, c[0].rn, (j + 2 >= ny ? j + 2 - ny : j + 2) * static_cast<Idx>(nx), i, iw,
          ie};
  float tv[2][9];
  load(a, plane, c[0], tv[0]);
  if (two) load(a, plane, c[1], tv[1]);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m == 1 && !two) break;
    inject(tv[m], a, plane, obst, c[m], arow, p);
    float out[9];
    const Idx x = c[m].rj + i;
    const float speed = lbm::lbm_collide(tv[m], obst[x] != 0, p.omega, out);
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k * plane + x] = out[k];
    *(m == 0 ? s0 : s1) = speed;
  }
}

// sync: (ntiles + ncw) step counters kCounterWords apart, zero at the
// launch's start (tile k's at k, the column pass of columns [32 q, 32 q +
// 32) at ntiles + q); part: kPartSlots x nby x nx column partials; colsum:
// chunk x nx column sums.  W: warps a tile (warps_per_tile).  With W = 1 a
// lane walks its column's B rows and adds their |u| in a register; with W
// > 1 warp g of the tile's group walks rows [g R, g R + R), R = B / W,
// keeps their |u| in shared memory (two buffers a group, flipped every
// tile: a warp can start the next tile while warp 0 still reads), and after
// the group's named barrier warp 0 adds the B rows in row order.
template <typename Idx, int W>
__global__ void __launch_bounds__(lbm::kThreads, lbm::aa::kMinBlocks)
    lbm_blocked_kernel(float* fa, float* fb, const uint8_t* __restrict__ obst, unsigned* sync,
                       float* part, float* colsum, float* tot_out, lbm::StepParams p, int chunk,
                       int B) {
  constexpr int kGroups = kWarps / W;  // tile groups a block
  __shared__ float sh[lbm::kThreads];
  __shared__ float speeds[W > 1 ? kGroups : 1][2][kMaxGroupRows][32];
  const int nx = p.nx, ny = p.ny;
  const Idx plane = static_cast<Idx>(ny) * nx;
  const int nby = (ny + B - 1) / B;
  const int nbw = (nx + 31) / 32;
  const int ntiles = nby * nbw;
  const int R = B / W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int tile_warps = gridDim.x * kWarps - nbw;  // the last nbw warps sum columns
  const int groups = tile_warps / W;
  const int grp = gw / W, g = gw - grp * W;  // the warp's group, and its place in it
  unsigned* tile_ctr = sync;
  unsigned* col_ctr = sync + static_cast<size_t>(ntiles) * kCounterWords;
  const Idx slot = static_cast<Idx>(nby) * nx;
  const Idx arow = p.accel_row >= 0 && p.accel_row < ny ? static_cast<Idx>(p.accel_row) * nx
                                                         : static_cast<Idx>(-1);

  if (grp < groups) {
    // The group's tiles [k0, k1), row blocks in order, 32-column tiles within.
    const int k0 = static_cast<int>(static_cast<long long>(grp) * ntiles / groups);
    const int k1 = static_cast<int>(static_cast<long long>(grp + 1) * ntiles / groups);
    const int by0 = k0 / nbw, bx0 = k0 - by0 * nbw;
    float(*spd)[kMaxGroupRows][32] = speeds[W > 1 ? warp / W : 0];
    int pb = 0;  // the group's speeds buffer, flipped every tile
    for (int t = 0; t < chunk; ++t) {
      const float* a = (t & 1) ? fb : fa;
      float* d = (t & 1) ? fa : fb;
      float* p_out = part + (t % kPartSlots) * slot;
      int by = by0, bx = bx0;
      for (int k = k0; k < k1; ++k) {
        // Lanes 0-8 wait for the 3 x 3 tiles around this one to finish step
        // t - 1; lane 9 for the column pass that last read this slot.
        if (lane < 9 && t > 0) {
          int qy = by + lane / 3 - 1, qx = bx + lane % 3 - 1;
          qy = qy < 0 ? qy + nby : (qy >= nby ? qy - nby : qy);
          qx = qx < 0 ? qx + nbw : (qx >= nbw ? qx - nbw : qx);
          poll(tile_ctr + static_cast<size_t>(qy * nbw + qx) * kCounterWords, t);
        } else if (lane == 9 && t >= kPartSlots && g == 0) {
          poll(col_ctr + static_cast<size_t>(bx) * kCounterWords, t - kPartSlots + 1);
        }
        __syncwarp();
        const int i = bx * 32 + lane;
        const bool col = i < nx;
        const int iw = i == 0 ? nx - 1 : i - 1;  // source column of cx = +1
        const int ie = i + 1 == nx ? 0 : i + 1;  // source column of cx = -1
        const int rb = by * B;                   // the row block's first row
        const int j0 = rb + g * R;               // this warp's rows [j0, j1)
        const int j1 = j0 + R < ny ? j0 + R : ny;
        float acc = 0.0f;
        if (col) {
          for (int j = j0; j < j1; j += 2) {
            float s0 = 0.0f, s1 = 0.0f;
            const bool two = j + 1 < j1;
            pair(a, d, plane, obst, j, two, i, iw, ie, ny, nx, arow, p, &s0, &s1);
            if constexpr (W == 1) {
              acc = acc + s0;
              if (two) acc = acc + s1;
            } else {
              spd[pb][j - rb][lane] = s0;
              if (two) spd[pb][j + 1 - rb][lane] = s1;
            }
          }
        }
        if constexpr (W > 1) {
          // The group's rows are in: warp 0 adds them in row order.
          asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / W), "r"(W * 32) : "memory");
          if (g == 0 && col) {
            const int r1 = rb + B < ny ? rb + B : ny;
            for (int r = 0; r < r1 - rb; ++r) acc = acc + spd[pb][r][lane];
          }
        }
        if (g == 0) {
          if (col) p_out[static_cast<Idx>(by) * nx + i] = acc;
          __syncwarp();  // the group's stores (and the warp's), seen through the release
          if (lane == 0) {
            lbm::aa::st_release(tile_ctr + static_cast<size_t>(k) * kCounterWords, t + 1);
          }
        }
        pb ^= 1;
        if (++bx == nbw) {
          bx = 0;
          ++by;
        }
      }
    }
  } else if (gw >= tile_warps) {
    // The column pass of columns [32 q, 32 q + 32): step t's partials summed
    // over the row blocks in block order, once the tiles of its columns
    // have finished step t.
    const int q = gw - tile_warps;
    const int i = q * 32 + lane;
    for (int t = 0; t < chunk; ++t) {
      // Each lane polls its share of the nby tiles' counters, all of them
      // in flight at once.
      for (unsigned polls = 0;; ++polls) {
        bool done = true;
        for (int b = lane; b < nby; b += 32) {
          const unsigned* c = tile_ctr + static_cast<size_t>(b * nbw + q) * kCounterWords;
          const bool ok = static_cast<int>(lbm::aa::ld_acquire(c) - (t + 1)) >= 0;
          done = done & ok;
        }
        if (done) break;
        if (polls == lbm::aa::kMaxPolls) __trap();
      }
      __syncwarp();
      if (i < nx) {
        const float* p_in = part + (t % kPartSlots) * slot + i;
        float acc = 0.0f;
#pragma unroll 16
        for (int b = 0; b < nby; ++b) acc = acc + __ldcg(p_in + static_cast<Idx>(b) * nx);
        colsum[static_cast<size_t>(t) * nx + i] = acc;
      }
      __syncwarp();
      if (lane == 0) lbm::aa::st_release(col_ctr + static_cast<size_t>(q) * kCounterWords, t + 1);
    }
  }

  // Each step's sum over the columns, once every column pass is done.
  if (static_cast<int>(blockIdx.x) < chunk) {
    for (int q = threadIdx.x; q < nbw; q += lbm::kThreads) {
      poll(col_ctr + static_cast<size_t>(q) * kCounterWords, chunk);
    }
    __syncthreads();
  }
  for (int t = blockIdx.x; t < chunk; t += gridDim.x) {
    lbm::lbm_reduce_row(colsum, nx, t, tot_out, sh);
  }
}

// Whether 9 planes of ny x nx stay below 2^31 elements (the int form).
bool int_offsets(int ny, int nx) { return 9LL * ny * nx < (1LL << 31); }

// Warps a tile: 1, doubled to 2, 4 or 8 while each warp keeps at least two
// rows (B / 2W >= 2, B <= kMaxGroupRows, int offsets) and the doubled split
// keeps within kTargetWarps warps, so that small grids still fill the card
// (tests/test_torch_blocked.py _warps_per_tile models it).
int warps_per_tile(int ny, int nx, int B) {
  int W = 1;
  const long long tiles = static_cast<long long>((ny + B - 1) / B) * ((nx + 31) / 32);
  while (W < kWarps && B <= kMaxGroupRows && B % (4 * W) == 0 && int_offsets(ny, nx) &&
         tiles * 2 * W <= kTargetWarps) {
    W *= 2;
  }
  return W;
}

// The kernel of a grid: the offsets' width and the warps a tile.
const void* kernel_for(int ny, int nx, int B) {
  if (!int_offsets(ny, nx)) return reinterpret_cast<const void*>(lbm_blocked_kernel<long long, 1>);
  switch (warps_per_tile(ny, nx, B)) {
    case 8:
      return reinterpret_cast<const void*>(lbm_blocked_kernel<int, 8>);
    case 4:
      return reinterpret_cast<const void*>(lbm_blocked_kernel<int, 4>);
    case 2:
      return reinterpret_cast<const void*>(lbm_blocked_kernel<int, 2>);
    default:
      return reinterpret_cast<const void*>(lbm_blocked_kernel<int, 1>);
  }
}

}  // namespace

extern "C" {

// Blocks of one cooperative K10 launch for row blocks of block_rows: one per
// two tile warps (W a tile of B rows x 32 columns) and column passes, and no
// more than can be resident on the device at once (a larger cooperative
// launch is refused), so the tiles spread over the card's SMs.  Returns <= 0
// on error, for a B that does not divide kThreads, or where the card cannot
// hold a warp per column pass and a block of tile warps.
int lbm_blocked_grid(int ny, int nx, int block_rows, int device) {
  if (ny < 1 || nx < 1 || block_rows < 1 || lbm::kThreads % block_rows) return -1;
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(ny, nx, block_rows),
                                                    lbm::kThreads, 0) != cudaSuccess)
    return -1;
  const long long ncw = (nx + 31) / 32;
  const long long work = static_cast<long long>((ny + block_rows - 1) / block_rows) * ncw *
                             warps_per_tile(ny, nx, block_rows) + ncw;
  const long long cap = static_cast<long long>(per_sm) * sms;
  if (cap * kWarps <= ncw + kWarps) return -1;
  const long long want = (work + 1) / 2;
  return static_cast<int>(want < cap ? want : cap);
}

// Run `chunk` steps in one cooperative launch of `grid` blocks (from
// lbm_blocked_grid) with row blocks of `block_rows`.  The state starts in fa
// and ends in fb for odd chunk, in fa for even.  sync holds (ceil(ny /
// block_rows) x ceil(nx / 32) + ceil(nx / 32)) x 32 zero 32-bit words (the
// step counters, launch-relative: zero them before each launch); part
// 4 x ceil(ny / block_rows) x nx floats (the ring of column partials),
// colsum chunk x nx; tot_out receives chunk per-step sums.  Returns the
// launch's error code, or cudaGetLastError().
int lbm_blocked_chunk(float* fa, float* fb, const uint8_t* obst, float* sync, float* part,
                      float* colsum, float* tot_out, int ny, int nx, int accel_row, float omega,
                      float w1, float w2, int chunk, int block_rows, int grid, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || grid < 1 || block_rows < 1 || lbm::kThreads % block_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(grid) * kWarps <= (nx + 31) / 32 + kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  unsigned* counters = reinterpret_cast<unsigned*>(sync);
  void* args[] = {&fa, &fb, &obst, &counters, &part, &colsum, &tot_out, &p, &chunk, &block_rows};
  err = cudaLaunchCooperativeKernel(kernel_for(ny, nx, block_rows), dim3(grid),
                                    dim3(lbm::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
