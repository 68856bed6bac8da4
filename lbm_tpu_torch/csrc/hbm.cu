// K9: the HBM-parts K-step sweep of one float32 grid, for Hopper, as ONE
// persistent launch per sweep.
//
// Replaces lbm_tpu/ops/hbm_pallas.py::_hbm_sweep_kernel (:157, entries
// make_sweep :272 and make_run_all :354): K steps of the whole ny x nx grid
// as P = ny / R row parts, part q's slab extended by K rows on each side
// (rows [qR - K, qR + R + K) mod ny of the input state), its R body rows
// written to the other state buffer (no buffer is read and written in one
// sweep, as B7 says at :25-27).  B7 fuses the parts loop into one call and
// hides the parts' copies behind a triple-buffered pipeline (:186-269):
// part q+1's slab loads while part q computes, part q-1's body drains.
//
// Bound: the state's bytes once per sweep from device memory (plus 2K/R of
// ghost rows read twice), and per cell-step of every part's extended slab 9
// values read and 9 written in L2 (the slots stay there: ops/hbm_cuda.py
// plan), plus each step's wait for the neighbouring blocks.
//
// Design.  Each part is swept as K8 sweeps a ca slab (csrc/ca_inplace.cu,
// the same cell walk and AA layouts of aa_inplace.cuh): step 0 pulls from
// the input rows and writes the P layout of the part's slot, the middle
// steps update the slot in place, the last step writes the body rows,
// canonical, to the output.  What B7's pipeline does, here:
//
// - One launch walks all P parts, part q in a slot of its own while the
//   part before it may still be in flight (S >= 2 slots of 9 x (R + 2K) x
//   nx floats), so a block that has finished part q starts part q + 1 at
//   once: no grid barrier and no launch between parts.  A block's step t of
//   a part waits only for the blocks within one row of its cells (the band
//   plan and step counters of aa_inplace.cuh, one 128-byte line per
//   counter).  Its step 0 waits until every block has finished the part
//   that held the slot before, the slot's last reads: each block raises a
//   count of blocks done with a part (release) before its last step's
//   count, and one thread a block polls it (acquire), in place of every
//   block polling every step counter (6 us a step less at 2048^2, PERF.md
//   Findings PR 14); no wait while a slot is new.
// - Loads ahead: a block's step 0 of part q + 1 pulls that part's rows from
//   device memory into its slot while other blocks still sweep part q.  An
//   L2 prefetch of the next part's rows a step or two before a part's end
//   (cp.async.bulk.prefetch.L2) lost or tied in 10 of 12 cells in turns:
//   the rows crowd the slots out of L2 (PERF.md Findings PR 14).
// - Stores behind: the last step's body rows stream to the output
//   (evict-first stores), written back while the next part is swept.
//
// The driven row has its own guard bytes per part (2 x nx, by step
// parity): it may fall in the ghost rows of two neighbouring parts, which
// now run at once.  Its injection at step 0 is recomputed from the input
// rows, as K8 does.  |u|: each block sums its body cells of every
// (part, step) into its own partial; after the sweep, once every block has
// counted its last step, block t adds level t's partials of each part in a
// fixed order and the parts in part order (B7's grouping, hbm_pallas.py
// :232-236).  No float atomics; two runs give the same bits.

#include "two_copy.cuh"

namespace {

namespace aa = lbm::aa;
using aa::Cell;
using lbm::two::kCounterWords;
using lbm::two::wait_blocks;

// Blocks per SM the registers are fitted to: at 3 (80 registers, 36 bytes
// of spills) K9 ran 4-12% faster than at K8's 4 (64 registers, 104-184
// bytes of spills in the cell loop) at 2048^2 and 4096^2, K = 4 and 8
// (PERF.md Findings PR 14).
constexpr int kMinBlocks = 3;

// aa::step_end, and at the end of a part (part_done not null) the count of
// blocks done with a part raised before the block's step count,
// both after every thread's stores of the step.
__device__ __forceinline__ void step_end(float acc, float* wsum, float* sum_out, unsigned* flag,
                                         unsigned count, unsigned* part_done) {
  const float w = lbm::lbm_warp_sum(acc);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < lbm::kThreads / 32; ++q) s = s + wsum[q];
    *sum_out = s;
    if (part_done) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(part_done) : "memory");
    }
    aa::st_release(flag, count);
  }
}

// Wait until the count of blocks done with a part reaches `count`.
__device__ __forceinline__ void wait_parts(const unsigned* part_done, unsigned count) {
  if (threadIdx.x == 0) {
    for (unsigned polls = 0; aa::ld_acquire(part_done) < count; ++polls) {
      if (polls == aa::kMaxPolls) __trap();
    }
  }
  __syncthreads();
}

// Plane 0 of global row e of the input, e in [-ny, 2 ny).
__device__ __forceinline__ const float* in_row(const float* fin, int e, int ny, int nx) {
  e = e < 0 ? e + ny : (e >= ny ? e - ny : e);
  return fin + static_cast<size_t>(e) * nx;
}

__global__ void __launch_bounds__(lbm::kThreads, kMinBlocks)
    lbm_hbm_kernel(const float* __restrict__ fin, float* fout,
                   const uint8_t* __restrict__ obst_parts, float* slots, uint8_t* gates,
                   float* partials, float* tot_out, lbm::StepParams p, int ny, int R, int K,
                   int S) {
  constexpr int kC = aa::kCells;
  __shared__ float sh[lbm::kThreads];
  __shared__ float wsum[lbm::kThreads / 32];
  const int nx = p.nx;
  const int ext = R + 2 * K, P = ny / R;
  const int plane = ext * nx;  // of a slot
  const long long gplane = static_cast<long long>(ny) * nx;
  const int G = gridDim.x;
  unsigned* counters = reinterpret_cast<unsigned*>(partials);
  unsigned* counter = counters + blockIdx.x * kCounterWords;
  unsigned* part_done = counters + G * kCounterWords;  // zero at a launch's start
  const int* plan = reinterpret_cast<const int*>(partials + kCounterWords * (G + 1));
  float* sums = partials + kCounterWords * (G + 1) + 4 * K * G;
  const unsigned base = __ldcg(counter);
  const int dj = lbm::kThreads / nx, di = lbm::kThreads - dj * nx;
  // Body rows [K, K + R) of a slab count in |u|.
  const int body_lo = K * nx, body_hi = (K + R) * nx;

  for (int q = 0; q < P; ++q) {
    float* a = slots + static_cast<size_t>(q % S) * 9 * plane;
    const int row0 = q * R - K;  // global row of extended row 0 (mod ny)
    const int d = ((p.accel_row - row0) % ny + ny) % ny;
    const int drow_off = d < ext ? d * nx : -1;
    const uint8_t* obst = obst_parts + static_cast<size_t>(q) * plane;
    uint8_t* gate = gates + static_cast<size_t>(q) * 2 * nx;
    const unsigned done = base + static_cast<unsigned>(q * K);  // part-steps before this part

    aa::Band next = aa::band(plan, 0, G);
    for (int t = 0; t < K; ++t) {
      const aa::Band bd = next;
      if (t + 1 < K) next = aa::band(plan, t + 1, G);  // in flight during this step
      const bool last = t + 1 == K;
      const bool neighbour = (t & 1) == 0;  // reads Q (t >= 2) or the input rows (t = 0)
      const uint8_t* gcur = gate + (t & 1) * nx;
      uint8_t* gnext = gate + (~t & 1) * nx;
      if (t > 0) {
        wait_blocks(counters, bd.dep_lo, bd.dep_n, G, done + t);
      } else if (q >= S) {  // the slot: every block done with part q - S
        wait_parts(part_done, static_cast<unsigned>((q - S + 1) * G));
      }
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
            const uint8_t* wj = obst + c.rj;
            lbm::lbm_pull_3rows<true>(in_row(fin, row0 + c.j - 1, ny, nx), gplane,
                                      in_row(fin, row0 + c.j, ny, nx), gplane,
                                      in_row(fin, row0 + c.j + 1, ny, nx), gplane, wj - nx, wj,
                                      wj + nx, c.rs == drow_off, c.rj == drow_off,
                                      c.rn == drow_off, c.i, p, tv[m]);
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
          if (last) {  // the body rows, streamed out past the slots in L2
            float* oc = fout + static_cast<size_t>(q) * R * nx + (c.rj - body_lo + c.i);
#pragma unroll
            for (int k = 0; k < 9; ++k) __stcs(oc + k * gplane, o[k]);
          } else if (neighbour) {
            aa::store_p(a, plane, c, o);
          } else {
            aa::store_local(a, plane, c.rj + c.i, o, false);
          }
          if (c.rj == drow_off && !last) gnext[c.i] = aa::stored_guard(o, !wall, p);
        }
      }
      step_end(acc, wsum, sums + static_cast<size_t>(q * K + t) * G + blockIdx.x, counter,
               done + t + 1, last ? part_done : nullptr);
    }
  }
  // The |u| pass: the blocks that sum a level wait for every block's last
  // step (the sweep's one barrier), then add each part's partials of the
  // level in block order and the parts in part order.
  if (static_cast<int>(blockIdx.x) < K) {
    wait_blocks(counters, 0, G, G, base + static_cast<unsigned>(P * K));
    // Every block is done: the part count starts the next launch at 0.
    if (blockIdx.x == 0 && threadIdx.x == 0) *part_done = 0;
  }
  for (int t = blockIdx.x; t < K; t += G) {
    float tot = 0.0f;
    for (int q = 0; q < P; ++q) {
      const float* r = sums + static_cast<size_t>(q * K + t) * G;
      float acc = 0.0f;
      for (int b = threadIdx.x; b < G; b += lbm::kThreads) acc = acc + __ldcg(r + b);
      const float total = lbm::lbm_block_sum(acc, sh);
      tot = q > 0 ? tot + total : total;
    }
    if (threadIdx.x == 0) tot_out[t] = tot;
  }
}

}  // namespace

extern "C" {

// Blocks of one K9 launch over slabs of ext x nx cells: no more than one
// per kThreads cells of a slab, and no more than can be resident at once
// (its waits need every block resident).  Returns <= 0 on error.
int lbm_hbm_grid(int ext, int nx, int device) {
  return lbm::two::grid_blocks(lbm_hbm_kernel, static_cast<long long>(ext) * nx, device);
}

// K9: one K-step sweep of the whole ny x nx float32 grid from fin into fout
// (another buffer), as P = ny / R row parts of R rows (R divides ny,
// K <= R, R + 2K <= ny: at most one image of the driven row in a slab), in
// order, in one cooperative launch of `grid` blocks (from lbm_hbm_grid(R +
// 2K, nx, device)).  slots: S >= 1 scratch slabs of 9 x (R + 2K) x nx
// floats, part q in slot q mod S; obst_parts: the parts' extended obstacle
// slabs ((R + 2K) x nx bytes each, in part order); gates: 2 x nx bytes per
// part.  partials, in 32-bit words (ops/resident_cuda.py partials_buffer):
// grid + 1 counters 32 words apart (the blocks' step counters and the count
// of blocks done with a part; zero before the first launch on the buffer,
// the kernel keeps them so between launches), the band plan of one slab (K
// x grid x 4 int32: ops/ca_cuda.py sweep_plan), then P x K x grid floats.
// tot_out receives the K per-level sums over the fluid cells, the parts
// added in order.  Returns the launch's error code, or cudaGetLastError().
int lbm_hbm_run(const float* fin, float* fout, const uint8_t* obst_parts, float* slots,
                uint8_t* gates, float* partials, float* tot_out, int ny, int nx, int R, int K,
                int S, int accel_row, float omega, float w1, float w2, int grid, void* stream,
                int device) {
  if (K < 1 || R < K || ny % R || R + 2 * K > ny || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lbm::StepParams p{R + 2 * K, nx, accel_row, omega, w1, w2};
  void* args[] = {&fin, &fout, &obst_parts, &slots, &gates, &partials, &tot_out, &p, &ny, &R,
                  &K, &S};
  return lbm::two::launch(lbm_hbm_kernel, args, static_cast<long long>(R + 2 * K) * nx, K, grid,
                          stream, device);
}

}  // extern "C"
