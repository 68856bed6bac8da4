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
// Bound: per cell-step a sweep moves about (hx hy x 37 + 37) / K bytes of
// device memory, with hx = (TW+2K)/TW and hy = (H+2K)/H the load overlaps
// of a strip and a band, against the one-step kernel's 73 B; the cell
// updates come from shared memory.  The first form of this kernel walked
// one row of every level per block barrier, its level-0 row loaded a step
// ahead in registers: one row in flight a block, and the split showed the
// walk waiting on those loads (device-memory latency a step) more than on
// its cells, and lost to K1 at every grid.  This design keeps more rows in
// flight, halves the barriers and compiles the host's strips in; at 2048^2,
// K = 4 its loads and its cells now take about the same time and do not
// overlap (PERF.md, Findings on the redesigned K5).
//
// Design.  A block owns a strip of TW output columns (plus a K-column halo
// on each side, recomputed) and a band of H output rows, and walks the
// band's rows upward, which takes the place of the TPU's sequential grid.
// Rows q count from the band's first level-0 row, y0 - K (periodic wrap by
// index arithmetic, any ny and nx); a band holds rows = H + 2K of them.
//
// - R = 2 rows of every level per walk step, one block barrier per step.
//   At step s level 0 has rows [sR, sR + R) and level l >= 1 computes rows
//   [sR - l(R+1), sR - l(R+1) + R), those in [l, rows - l).  Level l at
//   row q needs level l-1 at rows q-1, q, q+1, which earlier steps made
//   (a lag of R+1 rows a level), so the levels of one step are independent
//   and one barrier per step is enough.  Every (level, row) of a band is
//   computed once; level l is valid over [l, rows - l), so level K's rows
//   are the band's: B6's seam strip with validity growing level by level,
//   paid once per band.  A band takes ceil(rows / R) + K steps.
// - Balanced steps: thread j owns one (level, column) pair for the whole
//   walk (level by level, columns [l, cw - l) of level l) and computes its R
//   rows each step, the R cells' loads issued before their updates.  The
//   host picks the strip width so that the pairs, K cw - K(K+1), fill the
//   block (256 threads to K = 4, three blocks an SM; 512 above, one): every
//   step is one round on all of them.  The host's strips at K = 4 and 8 are
//   compiled in (KC, CWC), so the ring offsets are constants: the general
//   form spilled inside the walk at 80 registers.
// - Rings: level l < K keeps its last 2R+2 rows in shared memory (R being
//   written while level l+1 reads R+2 older ones).  Level 0 keeps 3R+2:
//   its rows are copied from device memory (cp.async) a step before the
//   barrier they must land by, so two steps before level 1 first reads
//   them (copies two steps further ahead gained nothing), straight into the
//   ring, in V-element copies
//   (16 bytes where nx allows; a row's copies start V-aligned, so the ring
//   row is offset by (x0 - K) mod V and a strip that wraps in x needs no
//   other path); int16 rows are copied raw and decoded by level 1 as it
//   pulls them, which reads each level-0 value once (a decode pass of its
//   own into a float32 ring ran 15% slower), and int16 with an odd nx,
//   which no copy can align, takes plain loads.  No level-0 values pass
//   through registers.
// - Level K's row is written at its true position in the other state
//   buffer.  On the TPU the forward sweep left the state rotated K rows and
//   a mirrored reverse sweep undid it, only because a Pallas output block
//   must sit at a block index (skew_pallas.py:19-30).  A CUDA block writes
//   where it likes, so there is no rotation and no reverse sweep: every
//   sweep is the same forward sweep, and the wrapper ping-pongs buffers.
// - The band's walls are bits in shared memory, packed once at the block's
//   start; the host sizes the bands so that the blocks fill the card's
//   slots (ops/skew_cuda.py band_rows).
//
// The driven row is injected at every level from the source cell's level
// l-1 values wherever it falls, warm-up rows and halo included (the pull
// below is lbm_pull_rows() op for op).  |u| of level l counts each fluid
// cell of the block's own rows and columns, inside the grid, once: a
// thread sums its pair's rows in row order, a warp per level sums the
// level's pairs in a fixed order into partials[sweep][l][block], and a
// fixed-order second launch sums the blocks.  No float atomics, so runs
// repeat bitwise.  ops/skew_cuda.py walk_plan models the schedule and the
// ring slots; tests/test_torch_skew.py holds it to every hazard.

#include "lbm_common.cuh"

namespace {

constexpr int kR = 2;               // rows of every level per walk step
constexpr int kRing = 2 * kR + 2;   // rows kept per level 1 .. K-1
constexpr int kPrefetch = 1;       // level-0 copies issued this many steps before they land
constexpr int kRing0 = (kPrefetch + 2) * kR + 2;  // level-0 rows kept: read, landed, in flight

// Elements of a level-0 plane row: room for a row offset by up to V - 1
// (V = 4 float32, 8 int16 elements a 16-byte copy), whole 16-byte rows.
__host__ __device__ constexpr int pitch0(int cw, int size) {
  return size == 4 ? (cw + 3 + 3) / 4 * 4 : (cw + 7 + 7) / 8 * 8;
}
// Bytes of a level-0 ring row of 9 planes, the larger of the two storages.
__host__ __device__ constexpr int ring0_row_bytes(int cw) {
  return 9 * (4 * pitch0(cw, 4) > 2 * pitch0(cw, 2) ? 4 * pitch0(cw, 4) : 2 * pitch0(cw, 2));
}

struct Strip {
  int K;
  int tw, bh;  // output columns of a strip, output rows of a band
  int cw;      // columns held: tw + 2K
  int rows;    // level-0 rows of a band: bh + 2K
  int nw;      // 32-bit wall words of a band row
  int nt;      // threads per block: 256, or 512 where the pairs need them
  int vec;     // elements per level-0 copy (1, 2, 4 or 8); 0: plain loads
};

// (level, column) pairs of a strip: sum over l = 1..K of cw - 2l.
int strip_pairs(int K, int cw) { return K * cw - K * (K + 1); }

Strip make_strip(int K, int tw, int bh, int vec) {
  Strip g;
  g.K = K;
  g.tw = tw;
  g.bh = bh;
  g.cw = tw + 2 * K;
  g.rows = bh + 2 * K;
  g.nw = (g.cw + 31) / 32;
  g.nt = strip_pairs(K, g.cw) <= 256 ? 256 : 512;
  g.vec = vec;
  return g;
}

bool strip_ok(const Strip& g) {
  return g.K >= 2 && g.tw >= 1 && g.bh >= 1 && strip_pairs(g.K, g.cw) <= 512;
}

// Dynamic shared memory of one block: the level-0 ring (sized for the
// larger storage), K-1 float32 rings, the |u| scratch, the copies' source
// columns, the band rows' grid rows, wall bits and driven-row flags.
size_t strip_smem(const Strip& g) {
  return static_cast<size_t>(kRing0) * ring0_row_bytes(g.cw) +
         static_cast<size_t>(g.K - 1) * kRing * 9 * g.cw * sizeof(float) +
         (static_cast<size_t>(g.nt) + pitch0(g.cw, 2) + g.rows +
          static_cast<size_t>(g.rows) * g.nw) *
             4 +
         g.rows;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(B)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy level-0 rows [ch R, ch R + R) of the band (those below rows) into
// their ring slots: warp w takes the (row, plane) pairs w, w + warps, ...,
// its lanes the row's copies of V elements.  gsrc[i] is the grid column of
// copy i (V-aligned: V divides nx).  vec 0 (int16, odd nx) loads plainly.
template <typename T, int NT>
__device__ __forceinline__ void issue_rows(const T* __restrict__ fin, T* ring0, const int* gsrc,
                                           const int* grow, int ch, int ncopies, int p0,
                                           const Strip& g, int nx, size_t plane) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bytes = g.vec * static_cast<int>(sizeof(T));
  for (int rk = warp; rk < kR * 9; rk += NT / 32) {
    const int r = rk / 9, k = rk - 9 * r;
    const int q = ch * kR + r;
    if (q >= g.rows) break;
    const T* src = fin + k * plane + static_cast<size_t>(grow[q]) * nx;
    T* dst = ring0 + ((q % kRing0) * 9 + k) * p0;
    if (bytes == 16) {
      for (int i = lane; i < ncopies; i += 32) cp_async<16>(dst + g.vec * i, src + gsrc[i]);
    } else if (bytes == 8) {
      for (int i = lane; i < ncopies; i += 32) cp_async<8>(dst + g.vec * i, src + gsrc[i]);
    } else if (bytes == 4) {
      for (int i = lane; i < ncopies; i += 32) cp_async<4>(dst + g.vec * i, src + gsrc[i]);
    } else {
      for (int i = lane; i < ncopies; i += 32) dst[i] = src[gsrc[i]];
    }
  }
}

__device__ __forceinline__ bool wall_at(const uint32_t* w, int c) {
  return (w[c >> 5] >> (c & 31)) & 1u;
}

// The injection gate of column c of a ring row (plane k at r + k ps),
// decoded from its storage S: lbm_gate_rows() on wall bits.
template <typename S>
__device__ __forceinline__ float gate(const S* r, const uint32_t* w, int ps, int c, float wt,
                                      const lbm::StepParams& p) {
  return lbm::lbm_guard(!wall_at(w, c), lbm::lbm_decode(r[3 * ps + c], 3, p),
                        lbm::lbm_decode(r[6 * ps + c], 6, p),
                        lbm::lbm_decode(r[7 * ps + c], 7, p), p)
             ? wt
             : 0.0f;
}

// lbm_pull_rows() from ring rows of storage S (float32 levels, or the raw
// level-0 ring, decoded as read): rj the cell's row, rs the row below, rn
// the row above; ws/wj/wn their wall bits, ds/dj/dn whether each is the
// driven row.  Same values, injection and operation order.
template <typename S>
__device__ __forceinline__ void pull(const S* rs, const S* rj, const S* rn, int ps,
                                     const uint32_t* ws, const uint32_t* wj, const uint32_t* wn,
                                     bool ds, bool dj, bool dn, int c, const lbm::StepParams& p,
                                     float t[9]) {
  t[0] = lbm::lbm_decode(rj[0 * ps + c], 0, p);
  t[1] = lbm::lbm_decode(rj[1 * ps + c - 1], 1, p);
  t[2] = lbm::lbm_decode(rs[2 * ps + c], 2, p);
  t[3] = lbm::lbm_decode(rj[3 * ps + c + 1], 3, p);
  t[4] = lbm::lbm_decode(rn[4 * ps + c], 4, p);
  t[5] = lbm::lbm_decode(rs[5 * ps + c - 1], 5, p);
  t[6] = lbm::lbm_decode(rs[6 * ps + c + 1], 6, p);
  t[7] = lbm::lbm_decode(rn[7 * ps + c + 1], 7, p);
  t[8] = lbm::lbm_decode(rn[8 * ps + c - 1], 8, p);
  if (dj) {
    t[1] = t[1] + gate(rj, wj, ps, c - 1, p.w1, p);
    t[3] = t[3] - gate(rj, wj, ps, c + 1, p.w1, p);
  }
  if (ds) {
    t[5] = t[5] + gate(rs, ws, ps, c - 1, p.w2, p);
    t[6] = t[6] - gate(rs, ws, ps, c + 1, p.w2, p);
  }
  if (dn) {
    t[7] = t[7] - gate(rn, wn, ps, c + 1, p.w2, p);
    t[8] = t[8] + gate(rn, wn, ps, c - 1, p.w2, p);
  }
}

// KC, CWC: a depth and strip width compiled in (the host's strips at K = 4
// and 8), so that ring offsets are constants; 0, 0: read from g.
template <typename T, int NT, int KC, int CWC>
__global__ void __launch_bounds__(NT, NT == 256 ? 3 : 1)
    lbm_skew_kernel(const T* __restrict__ fin, T* __restrict__ fout,
                    const uint8_t* __restrict__ obst, float* __restrict__ partials,
                    lbm::StepParams p, Strip g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = KC ? KC : g.K, cw = CWC ? CWC : g.cw, rows = g.rows;
  const int nw = CWC ? (CWC + 31) / 32 : g.nw, p0 = pitch0(cw, static_cast<int>(sizeof(T)));
  T* ring0 = reinterpret_cast<T*>(smem);  // [slot][plane][p0]
  float* rings = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kRing0) * ring0_row_bytes(cw));  // [level-1][slot][plane][cw]
  float* red = rings + static_cast<size_t>(K - 1) * kRing * 9 * cw;
  int* gsrc = reinterpret_cast<int*>(red + NT);
  int* grow = gsrc + pitch0(cw, 2);
  uint32_t* wbits = reinterpret_cast<uint32_t*>(grow + rows);  // [band row][word]
  uint8_t* drv = reinterpret_cast<uint8_t*>(wbits + static_cast<size_t>(rows) * nw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = blockIdx.y * g.bh, x0 = blockIdx.x * g.tw;
  const int nblocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  // Level-0 copies of V elements start V-aligned in the grid: the ring row
  // holds column c of the strip at c + o.
  const int V = g.vec > 1 ? g.vec : 1;
  const int vshift = __ffs(V) - 1;
  const int o = lbm::lbm_wrap(x0 - K, V);
  const int ncopies = (o + cw + V - 1) / V;

  for (int i = tid; i < ncopies; i += NT) gsrc[i] = lbm::lbm_wrap(x0 - K - o + V * i, p.nx);
  for (int q = tid; q < rows; q += NT) {
    const int r = lbm::lbm_wrap(y0 - K + q, p.ny);
    grow[q] = r;
    drv[q] = r == p.accel_row;
  }
  __syncthreads();
  for (int ch = 0; ch < kPrefetch; ++ch) {
    issue_rows<T, NT>(fin, ring0, gsrc, grow, ch, ncopies, p0, g, p.nx, plane);
    cp_async_commit();
  }
  // Wall bits: word q nw + j holds columns 32 j .. 32 j + 31 of band row q,
  // each thread packing whole words from 32 byte loads issued together.
  for (int i = tid; i < rows * nw; i += NT) {
    const int q = i / nw, j = i - q * nw;
    const uint8_t* orow = obst + static_cast<size_t>(grow[q]) * p.nx;
    uint32_t bits = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int c = 32 * j + b, e = c + o;
      if (c < cw && orow[gsrc[e >> vshift] + (e & (V - 1))] != 0) bits |= 1u << b;
    }
    wbits[i] = bits;
  }

  // This thread's (level, column) pair, fixed for the whole walk: pair j =
  // tid of the level-by-level order; l = K + 1 marks none.
  int l = K + 1, c = 0;
  {
    int j = tid, lv = 1;
    while (lv <= K && j >= cw - 2 * lv) {
      j -= cw - 2 * lv;
      ++lv;
    }
    if (lv <= K) {
      l = lv;
      c = j + lv;
    }
  }
  const int own_q_end = K + min(g.bh, p.ny - y0);
  const bool own_c = c >= K && c < K + min(g.tw, p.nx - x0);
  const uint32_t* wcol = wbits + (c >> 5);
  const uint32_t wbit = 1u << (c & 31);
  const T* r0 = ring0 + o;
  // Level l-1's ring (l >= 2) and level l's (l < K).
  const float* lower = rings + static_cast<size_t>(max(l - 2, 0)) * kRing * 9 * cw;
  float* mine = rings + static_cast<size_t>(max(min(l, K - 1) - 1, 0)) * kRing * 9 * cw;
  float acc = 0.0f;
  __syncthreads();

  // Ring slots, advanced R rows a step: lo of row a - 1 in level l-1's ring
  // (kRing0 slots for level 0, kRing above), mo of row a in level l's; a =
  // s R - l (R+1) is the first row level l computes at step s.
  const int mlo = l == 1 ? kRing0 : kRing;
  int lo = lbm::lbm_wrap(-l * (kR + 1) - 1, mlo);
  int mo = lbm::lbm_wrap(-l * (kR + 1), kRing);
  const int steps = (rows + kR - 1) / kR + K;
  for (int s = 0; s < steps; ++s) {
    issue_rows<T, NT>(fin, ring0, gsrc, grow, s + kPrefetch, ncopies, p0, g, p.nx, plane);
    cp_async_commit();
    if (l <= K) {
      const int a = s * kR - l * (kR + 1);
      int sl[kR + 2];  // slots of level l-1's rows a-1 .. a+R
      bool dr[kR + 2];  // whether each is the driven row
#pragma unroll
      for (int j = 0; j < kR + 2; ++j) {
        sl[j] = j == 0 ? lo : (sl[j - 1] + 1 == mlo ? 0 : sl[j - 1] + 1);
        dr[j] = drv[min(max(a - 1 + j, 0), rows - 1)];
      }
      float t[kR][9];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int q = a + i;
        if (q < l || q >= rows - l) continue;
        const uint32_t* wr = wbits + q * nw;
        if (l == 1) {
          pull<T>(r0 + sl[i] * 9 * p0, r0 + sl[i + 1] * 9 * p0, r0 + sl[i + 2] * 9 * p0, p0,
                  wr - nw, wr, wr + nw, dr[i], dr[i + 1], dr[i + 2], c, p, t[i]);
        } else {
          pull<float>(lower + sl[i] * 9 * cw, lower + sl[i + 1] * 9 * cw,
                      lower + sl[i + 2] * 9 * cw, cw, wr - nw, wr, wr + nw, dr[i], dr[i + 1],
                      dr[i + 2], c, p, t[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int q = a + i;
        if (q < l || q >= rows - l) continue;
        float out[9];
        const float speed = lbm::lbm_collide(t[i], (wcol[q * nw] & wbit) != 0, p.omega, out);
        const bool own = own_c && q >= K && q < own_q_end;
        if (own) acc = acc + speed;
        if (l < K) {
          const int m = mo + i >= kRing ? mo + i - kRing : mo + i;
          float* d = mine + m * 9 * cw + c;
#pragma unroll
          for (int k = 0; k < 9; ++k) d[k * cw] = out[k];
        } else if (own) {
          const size_t at = static_cast<size_t>(y0 + q - K) * p.nx + (x0 + c - K);
#pragma unroll
          for (int k = 0; k < 9; ++k) fout[k * plane + at] = lbm::lbm_encode<T>(out[k], k, p);
        }
      }
    }
    lo = lo + kR >= mlo ? lo + kR - mlo : lo + kR;
    mo = mo + kR >= kRing ? mo + kR - kRing : mo + kR;
    cp_async_wait<kPrefetch>();  // level-0 rows [sR, sR + R) have landed
    __syncthreads();
  }
  cp_async_wait<0>();

  // Per level: the pairs of level l are threads [first, first + cw - 2l);
  // warp w sums levels w + 1, w + 1 + warps, ... in a fixed order.
  red[tid] = l <= K ? acc : 0.0f;
  __syncthreads();
  for (int lv = warp + 1; lv <= K; lv += NT / 32) {
    const int first = (lv - 1) * cw - (lv - 1) * lv, n = cw - 2 * lv;
    float v = 0.0f;
    for (int j = lane; j < n; j += 32) v = v + red[first + j];
    v = lbm::lbm_warp_sum(v);
    if (lane == 0) partials[static_cast<size_t>(lv - 1) * nblocks + block] = v;
  }
}

dim3 strip_grid(int ny, int nx, const Strip& g) {
  return dim3((nx + g.tw - 1) / g.tw, (ny + g.bh - 1) / g.bh);
}

template <typename T, int NT, int KC, int CWC>
int skew_run(T* fa, T* fb, const uint8_t* obst, float* partials, float* tot_out,
             const lbm::StepParams& p, const Strip& g, int nsweeps, int batch, cudaStream_t s) {
  const size_t smem = strip_smem(g);
  cudaError_t err = cudaFuncSetAttribute(lbm_skew_kernel<T, NT, KC, CWC>,
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
    lbm_skew_kernel<T, NT, KC, CWC><<<grid, NT, smem, s>>>(
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

// The strips compiled in: the host's at K = 4 (61 columns, 256 threads)
// and K = 8 (57 columns, 512 threads); any other takes the general form.
constexpr int kStrip4 = 61 + 2 * 4, kStrip8 = 57 + 2 * 8;

template <typename T>
int skew_dispatch(T* fa, T* fb, const uint8_t* obst, float* partials, float* tot_out,
                  const lbm::StepParams& p, const Strip& g, int nsweeps, int batch,
                  cudaStream_t s) {
  if (g.K == 4 && g.cw == kStrip4)
    return skew_run<T, 256, 4, kStrip4>(fa, fb, obst, partials, tot_out, p, g, nsweeps, batch, s);
  if (g.K == 8 && g.cw == kStrip8)
    return skew_run<T, 512, 8, kStrip8>(fa, fb, obst, partials, tot_out, p, g, nsweeps, batch, s);
  return g.nt == 256
             ? skew_run<T, 256, 0, 0>(fa, fb, obst, partials, tot_out, p, g, nsweeps, batch, s)
             : skew_run<T, 512, 0, 0>(fa, fb, obst, partials, tot_out, p, g, nsweeps, batch, s);
}

// Elements per level-0 copy: the widest of 16, 8 and 4 bytes whose
// elements divide nx (so every row's copies start aligned), on buffers
// 16-byte aligned; int16 with an odd nx: 0, plain loads.
int copy_elements(int nx, bool i16, const void* fa, const void* fb) {
  const int size = i16 ? 2 : 4;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(fa) | reinterpret_cast<uintptr_t>(fb)) & 15) == 0;
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int v = bytes / size;
    if (nx % v == 0 && (aligned || v == 1)) return v;
  }
  return i16 ? 0 : 1;
}

}  // namespace

extern "C" {

// Blocks of one K5 launch: the row length of its partials buffer.
int lbm_skew_blocks(int ny, int nx, int K, int strip_w, int band_h) {
  const dim3 g = strip_grid(ny, nx, make_strip(K, strip_w, band_h, 1));
  return static_cast<int>(g.x * g.y);
}

// Dynamic shared memory (bytes) of one K5 block, or -1 for a strip whose
// (level, column) pairs exceed 512 threads.
int lbm_skew_smem(int K, int strip_w, int band_h) {
  const Strip g = make_strip(K, strip_w, band_h, 1);
  if (!strip_ok(g)) return -1;
  return static_cast<int>(strip_smem(g));
}

// Blocks of this strip and band the current device holds at once (SMs x
// blocks per SM), the host's measure for sizing bands; a negative CUDA
// error where it cannot say, -1 for a strip lbm_skew_smem() refuses.
int lbm_skew_grid(int K, int strip_w, int band_h) {
  const Strip g = make_strip(K, strip_w, band_h, 1);
  if (!strip_ok(g)) return -1;
  const size_t smem = strip_smem(g);
  int blocks = 0;
  cudaError_t err;
  if (g.K == 4 && g.cw == kStrip4)
    err = lbm::persistent_blocks<256>(lbm_skew_kernel<float, 256, 4, kStrip4>, smem, 1 << 30,
                                      &blocks);
  else if (g.K == 8 && g.cw == kStrip8)
    err = lbm::persistent_blocks<512>(lbm_skew_kernel<float, 512, 8, kStrip8>, smem, 1 << 30,
                                      &blocks);
  else if (g.nt == 256)
    err = lbm::persistent_blocks<256>(lbm_skew_kernel<float, 256, 0, 0>, smem, 1 << 30, &blocks);
  else
    err = lbm::persistent_blocks<512>(lbm_skew_kernel<float, 512, 0, 0>, smem, 1 << 30, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
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
  const Strip g = make_strip(K, strip_w, band_h, copy_elements(nx, i16 != 0, fa, fb));
  if (batch < 1 || !strip_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    lbm::lbm_set_codec(p, codec);
    return skew_dispatch(static_cast<int16_t*>(fa), static_cast<int16_t*>(fb), obst, partials,
                         tot_out, p, g, nsweeps, batch, s);
  }
  return skew_dispatch(static_cast<float*>(fa), static_cast<float*>(fb), obst, partials, tot_out,
                       p, g, nsweeps, batch, s);
}

}  // extern "C"
