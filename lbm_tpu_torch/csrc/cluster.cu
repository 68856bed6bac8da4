// K11: the ensemble's cluster-resident chunk for Hopper.
//
// Replaces no TPU kernel.  It takes over K2-batch's role (resident.cu, the
// ensemble's multi-step kernel): `chunk` steps of nb instances of one
// periodic ny x nx float32 grid in one launch.  lbm_tpu's ensemble runs
// the jnp step under jax.vmap (lbm_tpu/tools/ensemble.py::_step_traced
// :47, vmap :117) and reaches no pallas_call.
//
// What bounds K2-batch: its two copies of every state live in L2 and every
// cell-step reads 36 B from L2 and writes 36 B to it, so it runs at the L2
// tier's rate (PERF.md section 6).  K11 keeps each instance in the deepest
// tier it fits, the shared memory of one thread-block cluster, for the
// whole chunk:
//
// - Work map.  Instance b is run by cluster b of C blocks (C = 1, 2, 4, 8
//   or 16, and the block's threads, chosen by the host:
//   ops/ensemble_cuda.py::cluster_plan).  Block
//   r of the cluster owns the band of rows [r0, r0 + h): ny / C rows, the
//   first ny mod C bands one more.  It loads its band (9 planes a row) and
//   the band's mask rows with one above and one below into dynamic shared
//   memory once at the start, and stores the band once at the end, to fout
//   (the host passes fb for an odd chunk and fa for an even one, as
//   K2-batch leaves its state).  In between no state value touches L2.
//   Clusters wait on nothing outside themselves, so the launch is a plain
//   cluster launch (cudaLaunchKernelEx) of any nb, in waves where nb x C
//   blocks cannot all be resident.
// - One copy, updated in place.  Two copies of 256^2 do not fit 16 blocks,
//   so a block walks its band top to bottom in tiles of kTile cells (whole
//   rows; a thread takes kCells cells of a tile, kNT apart; a row is at
//   most a tile).  A tile pulls
//   and collides all its cells into registers, saves its last old row into
//   a carry row (the next tile's row below), waits at one block barrier,
//   and writes its cells in place.  Carries alternate between two buffers,
//   so the next tile's pulls need no barrier of their own: they read only
//   rows no earlier tile writes, and the carry the earlier tile filled
//   before its barrier.
// - Band edges through distributed shared memory.  Each block holds, by
//   step parity, the row below its band and the row above it; its
//   neighbours push them.  When a block writes its band's first or last
//   row at step t it also stores the new values into the previous rank's
//   row-above (first row) or the next rank's row-below (last row) of
//   parity t + 1 mod 2, through cg::cluster_group::map_shared_rank (C = 1:
//   the block's own rows, the periodic wrap; step 0's rows are pushed after
//   the load and a cluster barrier, so that no block writes into a block
//   that has not started).  One cluster barrier at the start of each step makes them
//   visible and covers both hazards: a row of parity t mod 2 is pushed
//   again during step t + 1, after the barrier of step t + 1, which every
//   reader of step t passed when done.  The barrier also orders the band's
//   writes of step t before its reads of step t + 1, so a step needs no
//   other barrier than its tiles'.  A row serves its neighbour only as a
//   row below (speeds 2, 5, 6 and the guard's 3, 6, 7) or above (4, 7, 8
//   and 3, 6, 7), so a pushed row or a carry holds those five planes only.
// - Loads.  Every pull reads the block's own shared memory at 32-bit
//   offsets (the band, the pushed rows, the carries); only the pushes
//   cross to another block.
// - Driven row.  Found by global row with the periodic wrap, its guard
//   recomputed from the source cell wherever it is read (pushed rows and
//   carries included), in lbm_pull_3rows()'s order of loads and
//   injections.
// - |u|: per step each thread sums its cells in cell order and each warp
//   by butterfly; at the next step warp 0 adds the warps' sums by a
//   butterfly into the block's sum of the step, kept in shared memory.
//   After the last step rank 0 adds, for each step, the C blocks' sums in
//   rank order, read through DSMEM, into tot_out[t * nb + b].  No float
//   atomics, so a run repeats bitwise.  The cell update is lbm_collide, so
//   instance b's fields are bitwise a single K2 run of its parameters.
//
// Shared memory of a block (f32, hmax = ceil(ny / C) rows): hmax x 9 x nx
// floats of band, 4 pushed rows and 2 carry rows of 9 x nx floats, 320
// floats of sums, (hmax + 2) x nx mask bytes: at most 232,448 B (the
// host's cluster_smem), the same in both forms.  256^2 at C = 16 takes
// 208,640 B, one block an SM.
// C = 16 needs the non-portable cluster size.
//
// Bound: 92 operations a fluid cell-step (the arithmetic alone; the
// launch's state bytes are read and written once); its tier is shared
// memory, 72 B of shared traffic a cell-step over the card's measured
// shared-memory rate (csrc/smem_copy.cu, 30.3 TB/s).  What holds it (8 x
// 256^2, PERF.md section 5): the cells, about 2.3 clocks a cell on an SM,
// and a step's barriers, carries and sums, 1.3 us a step, which nothing
// else on a block's SM covers.
//
// Two forms, one source: the kernel is a template on kNT, its threads a
// block, with kCells = 2 cells a thread, so a tile is 2048 or 1024 cells
// (tiles, carries, pushed rows, the barriers and the cell order are the
// same; only the tile's height and the warps summed change).  ptxas
// (sm_90a, nvcc -Xptxas -v; build/lbm_tpu_torch/<hash>/nvcc.log): 56
// registers and no spill in both (the split's variants, kPart 1 and 2: 48
// and 64 in the 1024 form).
// - kNT = 1024, __launch_bounds__(1024, 1): one block an SM, 57,344 of its
//   65,536 registers; up to 232,448 B of shared memory a block.
// - kNT = 512, __launch_bounds__(512, 2): two blocks an SM, of two
//   clusters, 2 x 512 x 56 = 57,344 registers, where two blocks' shared
//   memory fits the SM's 233,472 B with the card's 1 KB a block (at most
//   115,712 B a block: 128^2 at C = 8 takes 104,960 B).  While one block
//   waits at its cluster barrier the other works, so the SM's step costs
//   less than two of one block; and the card holds twice the clusters, so
//   a launch takes fewer waves (128^2 x 64 at C = 8: 3, not 5).
// The host's plan (ops/ensemble_cuda.py::cluster_plan) takes the form and
// C together, by a modelled step fitted to both forms' times pinned: 512
// threads only where its blocks share SMs (two fit, and the first wave
// holds more clusters than the card holds one block an SM), so never at
// 256^2 (one block of C = 16 an SM), nor for a few instances, where a
// block of 512 alone does a 1024-thread block's work with half the warps.
// Blocks of 256 threads with 4 cells a thread (128 registers, 8 warps an
// SM) took 50% more time at 256^2 x 7 than 1024 threads with 2 cells, in
// the design before the pushed rows (PERF.md, Findings).
//
// kPart, the form built: 0 (the package's) the whole chunk.  The split
// tools/kernel_times.py times is built as variants of this file with
// LBM_CLUSTER_PART defined ahead of it: 1 the loads and stores alone (no
// step); 2 the loads, stores, carries and barriers of every step, no cell.

#ifndef LBM_CLUSTER_PART
#define LBM_CLUSTER_PART 0
#endif

#include <cooperative_groups.h>

#include <mutex>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCells = 2;      // cells of a thread per tile
constexpr int kMaxWarps = 32;  // warps of the larger form's block
constexpr int kMaxChunk = 256;                         // steps of a launch (at most)
constexpr int kSumFloats = 2 * kMaxWarps + kMaxChunk;  // warp sums by parity, a sum a step
constexpr int kMaxSmem = 232448;
constexpr int kPart = LBM_CLUSTER_PART;

// The five planes a row serves its neighbour with: as the row below a cell
// (q-th of 2, 3, 5, 6, 7) and as the row above (3, 4, 6, 7, 8).
__device__ __forceinline__ int below_plane(int q) { return q + 2 + (q >= 2); }
__device__ __forceinline__ int above_plane(int q) { return q + 3 + (q >= 2); }

// The guarded injection of the source cell at column c of the row at
// offset `row` of shared memory (plane k at row + k * nx): w, or 0.0f.
__device__ __forceinline__ float gate(const float* sm, int row, const uint8_t* wall, int nx,
                                      int c, float w, const lbm::StepParams& p) {
  return lbm::lbm_guard(!wall[c], sm[row + 3 * nx + c], sm[row + 6 * nx + c],
                        sm[row + 7 * nx + c], p)
             ? w
             : 0.0f;
}

// lbm_pull_3rows() on rows of shared memory at 32-bit offsets: os the row
// below (source of cy = +1), oj the cell's own row, on the row above; ws /
// wj / wn their wall rows, ds / dj / dn whether each is the driven row.
// The same loads, injections and operation order.
__device__ __forceinline__ void pull(const float* sm, int os, int oj, int on, const uint8_t* ws,
                                     const uint8_t* wj, const uint8_t* wn, bool ds, bool dj,
                                     bool dn, int i, int iw, int ie, int nx,
                                     const lbm::StepParams& p, float t[9]) {
  t[0] = sm[oj + i];
  t[1] = sm[oj + nx + iw];
  t[2] = sm[os + 2 * nx + i];
  t[3] = sm[oj + 3 * nx + ie];
  t[4] = sm[on + 4 * nx + i];
  t[5] = sm[os + 5 * nx + iw];
  t[6] = sm[os + 6 * nx + ie];
  t[7] = sm[on + 7 * nx + ie];
  t[8] = sm[on + 8 * nx + iw];
  if (dj) {
    t[1] = t[1] + gate(sm, oj, wj, nx, iw, p.w1, p);
    t[3] = t[3] - gate(sm, oj, wj, nx, ie, p.w1, p);
  }
  if (ds) {
    t[5] = t[5] + gate(sm, os, ws, nx, iw, p.w2, p);
    t[6] = t[6] - gate(sm, os, ws, nx, ie, p.w2, p);
  }
  if (dn) {
    t[7] = t[7] - gate(sm, on, wn, nx, ie, p.w2, p);
    t[8] = t[8] + gate(sm, on, wn, nx, iw, p.w2, p);
  }
}

// kNT threads a block (1024: one block an SM; 512: two, of two clusters,
// where their shared memory fits the SM), a tile of kCells x kNT cells.
template <int kNT>
__global__ void __launch_bounds__(kNT, 1024 / kNT)
    lbm_cluster_batch_kernel(const float* fin, float* fout, const uint8_t* __restrict__ obst,
                             long long mask_stride, const float* __restrict__ scalars,
                             float* tot_out, lbm::StepParams p, int chunk) {
  constexpr int kTile = kCells * kNT;  // cells of a tile (at most)
  constexpr int kWarps = kNT / 32;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = static_cast<int>(blockIdx.x) / C;
  const int nb = static_cast<int>(gridDim.x) / C;
  p.omega = __ldg(scalars + 3 * b);
  p.w1 = __ldg(scalars + 3 * b + 1);
  p.w2 = __ldg(scalars + 3 * b + 2);
  const int ny = p.ny, nx = p.nx;
  const int base = ny / C, rem = ny - base * C;
  const int h = base + (r < rem ? 1 : 0);
  const int r0 = r * base + min(r, rem);
  const int hmax = base + (rem > 0 ? 1 : 0);
  const int R9 = 9 * nx;  // floats of a row
  // Offsets (floats) in shared memory: the band's rows, then by parity the
  // row below it (r0 - 1) and the row above it (r0 + h), which the
  // neighbours push, then two carry rows.
  float* sm = reinterpret_cast<float*>(smem4);
  const int lo_at = hmax * R9, hi_at = lo_at + 2 * R9, carry_at = hi_at + 2 * R9;
  float* wsum = sm + carry_at + 2 * R9;  // [parity][warp]
  float* psums = wsum + 2 * kMaxWarps;   // the block's |u| sum of each step
  uint8_t* wall = reinterpret_cast<uint8_t*>(psums + kMaxChunk);  // rows r0 - 1 .. r0 + h
  const size_t plane = static_cast<size_t>(ny) * nx;
  const float* src = fin + static_cast<size_t>(b) * 9 * plane;
  float* dst = fout + static_cast<size_t>(b) * 9 * plane;
  const uint8_t* ob = obst + b * mask_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int arow = p.accel_row >= 0 && p.accel_row < ny ? p.accel_row : -1;
  const int prev = r == 0 ? C - 1 : r - 1;  // the rank holding row r0 - 1
  const int next = r + 1 == C ? 0 : r + 1;  // the rank holding row r0 + h
  // Where this block's first row goes (prev's row above) and its last row
  // (next's row below), parity 0.
  float* push_first = cluster.map_shared_rank(sm + hi_at, prev);
  float* push_last = cluster.map_shared_rank(sm + lo_at, next);

  for (int line = warp; line < 9 * h; line += kWarps) {
    const int j = line / 9, k = line - 9 * j;
    const float* s = src + k * plane + static_cast<size_t>(r0 + j) * nx;
    float* d = sm + j * R9 + k * nx;
    for (int i = lane; i < nx; i += 32) d[i] = s[i];
  }
  for (int e = warp; e < h + 2; e += kWarps) {
    int g = r0 - 1 + e;
    g = g < 0 ? g + ny : (g >= ny ? g - ny : g);
    for (int i = lane; i < nx; i += 32) wall[e * nx + i] = ob[static_cast<size_t>(g) * nx + i];
  }
  // Every block of the cluster has started (its shared memory exists) and
  // loaded its band before any block pushes into another's.
  cluster.sync();

  if constexpr (kPart != 1) {
    for (int q = warp; q < 10; q += kWarps) {  // the edge rows of step 0, a plane a warp
      const int k = q < 5 ? above_plane(q) : below_plane(q - 5);
      float* d = (q < 5 ? push_first : push_last) + k * nx;
      const float* s = sm + (q < 5 ? 0 : (h - 1) * R9) + k * nx;
      for (int i = lane; i < nx; i += 32) d[i] = s[i];
    }
    const int R = kTile / nx;  // rows of a tile (nx <= kTile)
    // The thread's cells of a tile: row jq, column iq (west iw, east ie) of
    // the tile's rows.
    int jq[kCells], iq[kCells], iw[kCells], ie[kCells];
#pragma unroll
    for (int m = 0; m < kCells; ++m) {
      const int q = static_cast<int>(threadIdx.x) + m * kNT;
      jq[m] = q / nx;
      iq[m] = q - jq[m] * nx;
      iw[m] = iq[m] == 0 ? nx - 1 : iq[m] - 1;
      ie[m] = iq[m] + 1 == nx ? 0 : iq[m] + 1;
    }
    for (int t = 0; t < chunk; ++t) {
      // Every block is done with step t - 1 and has pushed its edge rows.
      cluster.sync();
      if (t > 0 && warp == 0) {  // the block's sum of step t - 1, warps in a fixed order
        const float v = lane < kWarps ? wsum[((t - 1) & 1) * kWarps + lane] : 0.0f;
        const float s = lbm::lbm_warp_sum(v);
        if (lane == 0) psums[t - 1] = s;
      }
      const int par = t & 1;
      const int below0 = lo_at + par * R9, above0 = hi_at + par * R9;
      float* to_first = push_first + (par ^ 1) * R9;
      float* to_last = push_last + (par ^ 1) * R9;
      float acc = 0.0f;
      for (int a = 0, k = 0; a < h; a += R, ++k) {
        const int rows = min(R, h - a);
        const int cur = carry_at + (k & 1) * R9;  // old row a - 1
        const int nxt = carry_at + ((k + 1) & 1) * R9;
        float out[kCells][9];
        if constexpr (kPart == 0) {
#pragma unroll
          for (int m = 0; m < kCells; ++m) {
            if (jq[m] >= rows) continue;
            const int j = a + jq[m];
            const int oj = j * R9;
            const int os = j == 0 ? below0 : (j == a ? cur : oj - R9);
            const int on = j + 1 == h ? above0 : oj + R9;
            const uint8_t* wj = wall + (j + 1) * nx;
            const int g = r0 + j;
            const int gs = g == 0 ? ny - 1 : g - 1;
            const int gn = g + 1 == ny ? 0 : g + 1;
            float tv[9];
            pull(sm, os, oj, on, wj - nx, wj, wj + nx, gs == arow, g == arow, gn == arow, iq[m],
                 iw[m], ie[m], nx, p, tv);
            acc = acc + lbm::lbm_collide(tv, wj[iq[m]] != 0, p.omega, out[m]);
          }
        }
        if (a + rows < h) {  // the tile's last old row: the next tile's row below
          const int lr = (a + rows - 1) * R9;
          for (int q = kWarps - 1 - warp; q < 5; q += kWarps) {  // the last warps
            const int kk = below_plane(q);
            for (int i = lane; i < nx; i += 32) sm[nxt + kk * nx + i] = sm[lr + kk * nx + i];
          }
        }
        __syncthreads();
        if constexpr (kPart == 0) {
#pragma unroll
          for (int m = 0; m < kCells; ++m) {
            if (jq[m] >= rows) continue;
            const int j = a + jq[m], i = iq[m];
            float* cj = sm + j * R9 + i;
#pragma unroll
            for (int kk = 0; kk < 9; ++kk) cj[kk * nx] = out[m][kk];
            // The band's edge rows also go to the neighbours, for step t + 1.
            if (j == 0) {
#pragma unroll
              for (int q = 0; q < 5; ++q) to_first[above_plane(q) * nx + i] = out[m][above_plane(q)];
            }
            if (j + 1 == h) {
#pragma unroll
              for (int q = 0; q < 5; ++q) to_last[below_plane(q) * nx + i] = out[m][below_plane(q)];
            }
          }
        }
      }
      const float w = lbm::lbm_warp_sum(acc);
      if (lane == 0) wsum[par * kWarps + warp] = w;
    }
    cluster.sync();
    if (warp == 0) {
      const float v = lane < kWarps ? wsum[((chunk - 1) & 1) * kWarps + lane] : 0.0f;
      const float s = lbm::lbm_warp_sum(v);
      if (lane == 0) psums[chunk - 1] = s;
    }
    cluster.sync();  // every block's sums are in place
    if (r == 0) {  // step t's C partials in rank order, a thread a step
      for (int t = threadIdx.x; t < chunk; t += kNT) {
        float s = 0.0f;
        for (int q = 0; q < C; ++q) s = s + *cluster.map_shared_rank(psums + t, q);
        tot_out[static_cast<size_t>(t) * nb + b] = s;
      }
    }
  }

  for (int line = warp; line < 9 * h; line += kWarps) {
    const int j = line / 9, k = line - 9 * j;
    float* d = dst + k * plane + static_cast<size_t>(r0 + j) * nx;
    const float* s = sm + j * R9 + k * nx;
    for (int i = lane; i < nx; i += 32) d[i] = s[i];
  }
  cluster.sync();  // no block leaves while rank 0 may read its sums
}

// The attributes every launch needs, set once per device for both forms:
// up to kMaxSmem bytes of dynamic shared memory, clusters of 16.
template <int kNT>
cudaError_t allow() {
  cudaError_t err = cudaFuncSetAttribute(lbm_cluster_batch_kernel<kNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lbm_cluster_batch_kernel<kNT>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaError_t prepare(int device) {
  static std::mutex lock;
  static bool done[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (done[device]) return cudaSuccess;
  cudaError_t err = allow<1024>();
  if (err != cudaSuccess) return err;
  if ((err = allow<512>()) != cudaSuccess) return err;
  done[device] = true;
  return cudaSuccess;
}

bool valid_cluster(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

bool valid_threads(int threads) { return threads == 1024 || threads == 512; }

// Bytes of dynamic shared memory a block needs (hmax band rows, nx columns).
long long smem_needed(int hmax, int nx) {
  return 4LL * ((hmax + 6LL) * 9 * nx + kSumFloats) + (hmax + 2LL) * nx;
}

// A launch of nb clusters of C blocks of `threads` threads, `smem` bytes of
// dynamic shared memory each (its attribute storage is the caller's).
cudaLaunchConfig_t cluster_config(int C, int nb, int threads, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nb * C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Clusters of C blocks of `threads` threads (1024 or 512) with `smem` bytes
// of dynamic shared memory each that can be resident on the device at once
// (cudaOccupancyMaxActiveClusters).  Returns <= 0 on error (-1 for an
// invalid C, size or block).
int lbm_cluster_batch_max_clusters(int C, int smem, int threads, int device) {
  if (!valid_cluster(C) || !valid_threads(threads) || smem < 0 || smem > kMaxSmem) return -1;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (prepare(device) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(C, 1, threads, smem, nullptr, &attr);
  int n = 0;
  const cudaError_t err =
      threads == 1024 ? cudaOccupancyMaxActiveClusters(&n, lbm_cluster_batch_kernel<1024>, &cfg)
                      : cudaOccupancyMaxActiveClusters(&n, lbm_cluster_batch_kernel<512>, &cfg);
  return err == cudaSuccess ? n : -1;
}

// K11: `chunk` steps of nb instances of an ny x nx float32 grid in one
// launch of nb clusters of C blocks of `threads` threads (1024 or 512; a
// row at most 2 x threads cells), `smem` bytes of dynamic shared memory a
// block (at least the layout's need for ceil(ny / C) rows).  Instance b's
// state is read at b * 9 * ny * nx of fin and written there in fout (fout
// may be fin); its mask at b * mask_stride bytes of obst (0: one mask for
// all); its omega, w1, w2 at scalars[3b .. 3b + 2] (device memory).
// tot_out receives chunk x nb sums, step-major.  Returns the launch's error
// code (a refused cluster launch included), or cudaGetLastError().
int lbm_cluster_batch_chunk(const float* fin, float* fout, const uint8_t* obst,
                            long long mask_stride, const float* scalars, float* tot_out, int ny,
                            int nx, int accel_row, int chunk, int C, int nb, int smem,
                            int threads, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_cluster(C) || !valid_threads(threads) || chunk < 1 || chunk > kMaxChunk ||
      nb < 1 || ny < C || nx < 1 || nx > kCells * threads || smem > kMaxSmem ||
      smem < smem_needed((ny + C - 1) / C, nx) || static_cast<long long>(nb) * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((err = prepare(device)) != cudaSuccess) return static_cast<int>(err);
  lbm::StepParams p{ny, nx, accel_row, 0.0f, 0.0f, 0.0f};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, nb, threads, smem, static_cast<cudaStream_t>(stream), &attr);
  err = threads == 1024
            ? cudaLaunchKernelEx(&cfg, lbm_cluster_batch_kernel<1024>, fin, fout, obst,
                                 mask_stride, scalars, tot_out, p, chunk)
            : cudaLaunchKernelEx(&cfg, lbm_cluster_batch_kernel<512>, fin, fout, obst,
                                 mask_stride, scalars, tot_out, p, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
