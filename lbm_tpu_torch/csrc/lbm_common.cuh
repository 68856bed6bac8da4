// Shared per-cell D2Q9-BGK update for the CUDA kernels of lbm_tpu_torch.
//
// Every kernel (step.cu, resident.cu, inplace.cu, temporal.cu, skew.cu,
// ghosted.cu, ca_resident.cu, ca_inplace.cu, hbm.cu) loads state through
// lbm_load(), updates a cell with lbm_collide() and stores with
// lbm_encode(), so they stay bitwise equal to each other and to the plain
// torch step (ops/stencil_math.py, which this file follows op for op, in the
// same association order).  step.cu pulls a cell's 9 values with
// lbm_pull() (K1) and lbm_pull_slab() (K1-slab, the sharded modes' slab
// step); the two-copy kernels K2 and K6 (two_copy.cuh) from their copies,
// K6's rows next to a ghost with lbm_pull_slab(); the ca engines K7 and K8
// and K9's step 0 from a ghost-extended slab (Ext) with lbm_pull_3rows();
// inplace.cu, ca_inplace.cu and hbm.cu read them from their in-place
// layout; temporal.cu and skew.cu pull from levels held in shared memory
// with lbm_pull_rows().
//
// Storage: the state is float32, or int16 fixed-point deviations from rest
// (ops/quant.py).  lbm_load() dequantizes and lbm_encode() quantizes with
// the host-computed float32 constants in StepParams::q (K1-i16 and
// K1-slab-i16: lbm_decode_word() and lbm_encode_bits(), the same values
// without conversion instructions), so every kernel
// computes in float32 whatever the storage, and the injection guard sees
// dequantized values, as B1 does (lbm_tpu/ops/fused_pallas.py:304-307).
//
// Bitwise equality with the torch step needs uncontracted IEEE float32: the
// library is built with --fmad=false (no a*b+c -> FMA), -prec-div=true and
// -prec-sqrt=true (correctly rounded / and sqrt), and never with
// --use_fast_math (ops/_build.py).
//
// Layout: f is (9, ny, nx) float32 or int16, plane k at f + k*ny*nx, row-major; the
// obstacle mask is (ny, nx) bytes, nonzero = wall.  Speed numbering as in
// core/lattice.py:
//
//     6 2 5
//     3 0 1        cx = (0, 1, 0,-1, 0, 1,-1,-1, 1)
//     7 4 8        cy = (0, 0, 1, 0,-1, 1, 1,-1,-1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace lbm {

constexpr int kThreads = 256;  // threads per block of every kernel

// Float32 constants, rounded exactly as np.float32(...) on the host.
#define LBM_W0 (static_cast<float>(4.0 / 9.0))
#define LBM_W1 (static_cast<float>(1.0 / 9.0))
#define LBM_W2 (static_cast<float>(1.0 / 36.0))

// int16 codec constants, float32 values computed on the host
// (ops/quant.py codec_constants): q = clamp(rint((f - rest) * scale)),
// f = q * inv + rest.  Unused (zero) for float32 state.
struct Codec {
  float scale[9];
  float inv[9];
  float rest[9];
};

struct StepParams {
  int ny;
  int nx;
  int accel_row;  // ny - 2: the driven row
  float omega;
  float w1;  // density * accel / 9
  float w2;  // density * accel / 36
  Codec q;
};

// Fill p.q from a host array of 27 floats (scales, inverse scales, rest
// values), or leave it zero for a null pointer (float32 state).
inline void lbm_set_codec(StepParams& p, const float* codec) {
  if (codec == nullptr) return;
  for (int k = 0; k < 9; ++k) {
    p.q.scale[k] = codec[k];
    p.q.inv[k] = codec[9 + k];
    p.q.rest[k] = codec[18 + k];
  }
}

__device__ __forceinline__ float lbm_decode(float v, int, const StepParams&) { return v; }
__device__ __forceinline__ float lbm_decode(int16_t v, int k, const StepParams& p) {
  return static_cast<float>(v) * p.q.inv[k] + p.q.rest[k];  // --fmad=false: no FMA
}

template <typename T>
__device__ __forceinline__ T lbm_encode(float v, int k, const StepParams& p);
template <>
__device__ __forceinline__ float lbm_encode<float>(float v, int, const StepParams&) {
  return v;
}
template <>
__device__ __forceinline__ int16_t lbm_encode<int16_t>(float v, int k, const StepParams& p) {
  // torch.round and rintf both round half to even.
  const float r = rintf((v - p.q.rest[k]) * p.q.scale[k]);
  return static_cast<int16_t>(fminf(fmaxf(r, -32767.0f), 32767.0f));
}

// The same codec with no instruction of the conversion pipe, decoding two
// int16 values packed in a 32-bit word (the low half first): bitwise equal
// to lbm_decode() / lbm_encode() for every input (tests/test_torch_codec.py
// runs the formulas in numpy float32).  K1-i16 and K1-slab-i16 use it.
//
// Decode: flipping the sign bit makes q + 32768 (0..65535) of each half;
// ORed under the bits of 12582912.0f (0x4B400000: exponent 2^23, the low 16
// mantissa bits zero) it is the float 12582912 + q + 32768 exactly, so one
// exact subtraction gives (float)q.  The multiply and add that follow are
// lbm_decode()'s.
__device__ __forceinline__ void lbm_decode_word(uint32_t w, int k, const StepParams& p,
                                                float* lo, float* hi) {
  const uint32_t u = w ^ 0x80008000u;
  const float a = __uint_as_float(__byte_perm(u, 0x4B400000u, 0x7610)) - 12615680.0f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B400000u, 0x7632)) - 12615680.0f;
  *lo = a * p.q.inv[k] + p.q.rest[k];  // --fmad=false: no FMA
  *hi = b * p.q.inv[k] + p.q.rest[k];
}

// Encode: clamp first (the bounds are integers and rint is monotone, so
// clamp-then-round equals round-then-clamp; fmaxf returns -32767 for NaN
// either way), then add 12582912.0f: in [2^23, 2^24) the float's unit is
// 1, so the sum rounds to nearest, half to even, as rintf does, and its low
// 16 bits are the two's-complement int16 (two of them pack into a word by
// __byte_perm(lo, hi, 0x5410)).
__device__ __forceinline__ uint32_t lbm_encode_bits(float v, int k, const StepParams& p) {
  const float r = fminf(fmaxf((v - p.q.rest[k]) * p.q.scale[k], -32767.0f), 32767.0f);
  return __float_as_uint(r + 12582912.0f);
}

// State loads of plane k, decoded to float32.  kL2 = true reads through L2
// only (ld.global.cg), bypassing the per-SM L1, which is not coherent with
// other SMs' writes: the persistent kernels read values other blocks wrote
// in the same launch.  The one-step kernel reads a buffer no one writes
// during its launch and takes the default cached load.
template <bool kL2, typename T>
__device__ __forceinline__ float lbm_load(const T* a, int k, const StepParams& p) {
  if constexpr (kL2) {
    return lbm_decode(__ldcg(a), k, p);
  } else {
    return lbm_decode(*a, k, p);
  }
}

// Injection guard of a driven-row cell from its pre-injection values: fluid,
// and f3 - w1, f6 - w2, f7 - w2 all strictly positive
// (SerialCode/d2q9-bgk.c:216-246).
__device__ __forceinline__ bool lbm_guard(bool fluid, float f3, float f6, float f7,
                                          const StepParams& p) {
  return fluid && (f3 - p.w1 > 0.0f) && (f6 - p.w2 > 0.0f) && (f7 - p.w2 > 0.0f);
}

// The injection of the driven row's cell (sj, si), guarded on its
// pre-injection values: w, or 0.0f where the guard is false.
template <typename T>
__device__ __forceinline__ float lbm_accel_gate(const T* f, const uint8_t* obst,
                                                size_t plane, int sj, int si,
                                                float w, const StepParams& p) {
  const size_t c = static_cast<size_t>(sj) * p.nx + si;
  const bool ok = lbm_guard(!obst[c], lbm_load<false>(f + 3 * plane + c, 3, p),
                            lbm_load<false>(f + 6 * plane + c, 6, p),
                            lbm_load<false>(f + 7 * plane + c, 7, p), p);
  return ok ? w : 0.0f;
}

// Pull the 9 streamed values of cell (j, i): t[k] = f[k][(j-cy) mod ny][(i-cx) mod nx].
// The injection happens before streaming in the reference, so a value pulled
// from the driven row carries its source cell's own injection.  The guard is
// recomputed here from the source cell (the TPU kernel does the same for its
// ghost rows, lbm_tpu/ops/fused_pallas.py:316-325).  K1 reads a buffer no
// one writes during its launch, so the loads take the default cached path.
template <typename T>
__device__ __forceinline__ void lbm_pull(const T* f, const uint8_t* obst, int j,
                                         int i, const StepParams& p, float t[9]) {
  const size_t plane = static_cast<size_t>(p.ny) * p.nx;
  const int js = (j == 0) ? p.ny - 1 : j - 1;      // source row of cy = +1
  const int jn = (j + 1 == p.ny) ? 0 : j + 1;      // source row of cy = -1
  const int iw = (i == 0) ? p.nx - 1 : i - 1;      // source column of cx = +1
  const int ie = (i + 1 == p.nx) ? 0 : i + 1;      // source column of cx = -1
  const size_t rj = static_cast<size_t>(j) * p.nx;
  const size_t rs = static_cast<size_t>(js) * p.nx;
  const size_t rn = static_cast<size_t>(jn) * p.nx;

  t[0] = lbm_load<false>(f + 0 * plane + rj + i, 0, p);
  t[1] = lbm_load<false>(f + 1 * plane + rj + iw, 1, p);
  t[2] = lbm_load<false>(f + 2 * plane + rs + i, 2, p);
  t[3] = lbm_load<false>(f + 3 * plane + rj + ie, 3, p);
  t[4] = lbm_load<false>(f + 4 * plane + rn + i, 4, p);
  t[5] = lbm_load<false>(f + 5 * plane + rs + iw, 5, p);
  t[6] = lbm_load<false>(f + 6 * plane + rs + ie, 6, p);
  t[7] = lbm_load<false>(f + 7 * plane + rn + ie, 7, p);
  t[8] = lbm_load<false>(f + 8 * plane + rn + iw, 8, p);

  // Speeds 1, 3 come from row j; 5, 6 from row js; 7, 8 from row jn.
  if (j == p.accel_row) {
    t[1] = t[1] + lbm_accel_gate(f, obst, plane, j, iw, p.w1, p);
    t[3] = t[3] - lbm_accel_gate(f, obst, plane, j, ie, p.w1, p);
  }
  if (js == p.accel_row) {
    t[5] = t[5] + lbm_accel_gate(f, obst, plane, js, iw, p.w2, p);
    t[6] = t[6] - lbm_accel_gate(f, obst, plane, js, ie, p.w2, p);
  }
  if (jn == p.accel_row) {
    t[7] = t[7] - lbm_accel_gate(f, obst, plane, jn, ie, p.w2, p);
    t[8] = t[8] + lbm_accel_gate(f, obst, plane, jn, iw, p.w2, p);
  }
}

// A row slab of one shard (the sharded modes): n body rows and one ghost
// row on each side, each in its own buffer with its own plane stride (in
// elements), so that a window of a larger tensor serves as any of them.
// Row r of plane k is body[k * ps + r * nx] for 0 <= r < n, lo[k * ps_lo]
// for r = -1 and hi[k * ps_hi] for r = n.  The obstacle slab is (n + 2, nx)
// bytes, row r at (r + 1) * nx.
template <typename T>
struct Slab {
  const T* body;
  long long ps;
  const T* lo;
  long long ps_lo;
  const T* hi;
  long long ps_hi;
};

// The guarded injection of slab row r's cell si, read from that row (plane
// 0 at `row`, plane stride `ps`): w, or 0.0f where the guard is false.
template <bool kL2, typename T>
__device__ __forceinline__ float lbm_slab_gate(const T* row, long long ps, const uint8_t* wall,
                                               int si, float w, const StepParams& p) {
  const bool ok = lbm_guard(!wall[si], lbm_load<kL2>(row + 3 * ps + si, 3, p),
                            lbm_load<kL2>(row + 6 * ps + si, 6, p),
                            lbm_load<kL2>(row + 7 * ps + si, 7, p), p);
  return ok ? w : 0.0f;
}

// lbm_pull() on a slab: the 9 streamed values of body cell (j, i),
// t[k] = slab[k][j - cy][(i - cx) mod nx], y reads from the ghost rows at
// the edges.  The driven row is found by global row (row_offset + r for
// slab row r, ghosts included, never wrapped), as lbm_tpu's
// fused_step_slab injects every slab row whose global index is accel_row;
// the guard is recomputed from the source cell, ghost rows included.
template <bool kL2, typename T>
__device__ __forceinline__ void lbm_pull_slab(const Slab<T>& s, int n, const uint8_t* obst,
                                              int row_offset, int j, int i,
                                              const StepParams& p, float t[9]) {
  const int nx = p.nx;
  const int iw = (i == 0) ? nx - 1 : i - 1;  // source column of cx = +1
  const int ie = (i + 1 == nx) ? 0 : i + 1;  // source column of cx = -1
  const T* rj = s.body + static_cast<size_t>(j) * nx;
  const long long pj = s.ps;
  const bool lo_edge = (j == 0);
  const bool hi_edge = (j + 1 == n);
  const T* rs = lo_edge ? s.lo : rj - nx;  // source row of cy = +1
  const long long psr = lo_edge ? s.ps_lo : s.ps;
  const T* rn = hi_edge ? s.hi : rj + nx;  // source row of cy = -1
  const long long pnr = hi_edge ? s.ps_hi : s.ps;

  t[0] = lbm_load<kL2>(rj + 0 * pj + i, 0, p);
  t[1] = lbm_load<kL2>(rj + 1 * pj + iw, 1, p);
  t[2] = lbm_load<kL2>(rs + 2 * psr + i, 2, p);
  t[3] = lbm_load<kL2>(rj + 3 * pj + ie, 3, p);
  t[4] = lbm_load<kL2>(rn + 4 * pnr + i, 4, p);
  t[5] = lbm_load<kL2>(rs + 5 * psr + iw, 5, p);
  t[6] = lbm_load<kL2>(rs + 6 * psr + ie, 6, p);
  t[7] = lbm_load<kL2>(rn + 7 * pnr + ie, 7, p);
  t[8] = lbm_load<kL2>(rn + 8 * pnr + iw, 8, p);

  // Speeds 1, 3 come from row j; 5, 6 from row j - 1; 7, 8 from row j + 1.
  const int g = row_offset + j;
  const uint8_t* wall = obst + static_cast<size_t>(j + 1) * nx;  // obstacle row of body row j
  if (g == p.accel_row) {
    t[1] = t[1] + lbm_slab_gate<kL2>(rj, pj, wall, iw, p.w1, p);
    t[3] = t[3] - lbm_slab_gate<kL2>(rj, pj, wall, ie, p.w1, p);
  }
  if (g - 1 == p.accel_row) {
    t[5] = t[5] + lbm_slab_gate<kL2>(rs, psr, wall - nx, iw, p.w2, p);
    t[6] = t[6] - lbm_slab_gate<kL2>(rs, psr, wall - nx, ie, p.w2, p);
  }
  if (g + 1 == p.accel_row) {
    t[7] = t[7] - lbm_slab_gate<kL2>(rn, pnr, wall + nx, ie, p.w2, p);
    t[8] = t[8] + lbm_slab_gate<kL2>(rn, pnr, wall + nx, iw, p.w2, p);
  }
}

// The ghost-extended slab of one shard (the ca engines and the HBM-parts
// sweep): K rows below the body (lo), the n body rows and K rows above it
// (hi), each a window with its own plane stride (elements), rows nx apart.
// Extended row e < K is lo row e, K <= e < K + n body row e - K, and
// e >= K + n hi row e - K - n.  A buffer that holds all the rows (a
// kernel's scratch) is the window lo with K = its row count.
template <typename T>
struct Ext {
  const T* lo;
  long long ps_lo;
  const T* body;
  long long ps;
  const T* hi;
  long long ps_hi;
  int K;
  int n;
};

// Plane 0 of extended row e, and its plane stride in *ps.
template <typename T>
__device__ __forceinline__ const T* lbm_ext_row(const Ext<T>& w, int e, int nx, long long* ps) {
  if (e < w.K) {
    *ps = w.ps_lo;
    return w.lo + static_cast<size_t>(e) * nx;
  }
  e -= w.K;
  if (e < w.n) {
    *ps = w.ps;
    return w.body + static_cast<size_t>(e) * nx;
  }
  *ps = w.ps_hi;
  return w.hi + static_cast<size_t>(e - w.n) * nx;
}

// lbm_pull() from three rows that each have their own plane stride: rj the
// cell's own row, rs the row below (source of cy = +1), rn the row above
// (cy = -1); ws / wj / wn their wall rows; ds / dj / dn whether each is the
// driven row.  x wraps; the guard is recomputed from the source cell.  The
// same loads, injections and operation order as lbm_pull().
template <bool kL2, typename T>
__device__ __forceinline__ void lbm_pull_3rows(const T* rs, long long pss, const T* rj,
                                               long long psj, const T* rn, long long psn,
                                               const uint8_t* ws, const uint8_t* wj,
                                               const uint8_t* wn, bool ds, bool dj, bool dn,
                                               int i, const StepParams& p, float t[9]) {
  const int iw = (i == 0) ? p.nx - 1 : i - 1;  // source column of cx = +1
  const int ie = (i + 1 == p.nx) ? 0 : i + 1;  // source column of cx = -1
  t[0] = lbm_load<kL2>(rj + 0 * psj + i, 0, p);
  t[1] = lbm_load<kL2>(rj + 1 * psj + iw, 1, p);
  t[2] = lbm_load<kL2>(rs + 2 * pss + i, 2, p);
  t[3] = lbm_load<kL2>(rj + 3 * psj + ie, 3, p);
  t[4] = lbm_load<kL2>(rn + 4 * psn + i, 4, p);
  t[5] = lbm_load<kL2>(rs + 5 * pss + iw, 5, p);
  t[6] = lbm_load<kL2>(rs + 6 * pss + ie, 6, p);
  t[7] = lbm_load<kL2>(rn + 7 * psn + ie, 7, p);
  t[8] = lbm_load<kL2>(rn + 8 * psn + iw, 8, p);
  if (dj) {
    t[1] = t[1] + lbm_slab_gate<kL2>(rj, psj, wj, iw, p.w1, p);
    t[3] = t[3] - lbm_slab_gate<kL2>(rj, psj, wj, ie, p.w1, p);
  }
  if (ds) {
    t[5] = t[5] + lbm_slab_gate<kL2>(rs, pss, ws, iw, p.w2, p);
    t[6] = t[6] - lbm_slab_gate<kL2>(rs, pss, ws, ie, p.w2, p);
  }
  if (dn) {
    t[7] = t[7] - lbm_slab_gate<kL2>(rn, psn, wn, ie, p.w2, p);
    t[8] = t[8] + lbm_slab_gate<kL2>(rn, psn, wn, iw, p.w2, p);
  }
}

// Bounce-back on walls, paired-equilibrium BGK on fluid cells
// (ops/stencil_math.py moments + collide).  Returns |u| from the
// pre-collision moments on fluid cells and 0 on walls.
__device__ __forceinline__ float lbm_collide(const float t[9], bool wall, float omega,
                                             float out[9]) {
  const float rho =
      ((((((((t[0] + t[1]) + t[2]) + t[3]) + t[4]) + t[5]) + t[6]) + t[7]) + t[8]);
  const float u_x = (((t[1] + t[5]) + t[8]) - ((t[3] + t[6]) + t[7])) / rho;
  const float u_y = (((t[2] + t[5]) + t[6]) - ((t[4] + t[7]) + t[8])) / rho;
  const float u_sq = u_x * u_x + u_y * u_y;
  if (wall) {
    out[0] = t[0];
    out[1] = t[3];
    out[2] = t[4];
    out[3] = t[1];
    out[4] = t[2];
    out[5] = t[7];
    out[6] = t[8];
    out[7] = t[5];
    out[8] = t[6];
    return 0.0f;
  }
  const float usq_term = u_sq * 1.5f;
  const float w0rho = rho * LBM_W0;
  const float w1rho = rho * LBM_W1;
  const float w2rho = rho * LBM_W2;
  const float base = 1.0f - usq_term;
  float d[9];
  d[0] = w0rho * base;
  {
    const float a = w1rho * (base + (u_x * u_x) * 4.5f);
    const float b = w1rho * (u_x * 3.0f);
    d[1] = a + b;
    d[3] = a - b;
  }
  {
    const float a = w1rho * (base + (u_y * u_y) * 4.5f);
    const float b = w1rho * (u_y * 3.0f);
    d[2] = a + b;
    d[4] = a - b;
  }
  {
    const float u = u_x + u_y;
    const float a = w2rho * (base + (u * u) * 4.5f);
    const float b = w2rho * (u * 3.0f);
    d[5] = a + b;
    d[7] = a - b;
  }
  {
    const float u = u_y - u_x;
    const float a = w2rho * (base + (u * u) * 4.5f);
    const float b = w2rho * (u * 3.0f);
    d[6] = a + b;
    d[8] = a - b;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = t[k] + (d[k] - t[k]) * omega;
  return sqrtf(u_sq);
}

// Pull the 9 streamed values of local column c of a row from rows held on
// chip (the temporal kernels' shared-memory levels): rj is the cell's own
// row, rs the row below it (source of cy = +1), rn the row above (cy = -1);
// plane k of a row starts at k * ps.  ws/wj/wn are the wall bytes of those
// rows and ds/dj/dn whether each is the driven row.  Same values, same
// injection and same operation order as lbm_pull(): t[k] = level[k] at
// (row - cy, c - cx), plus the source cell's guarded injection.
__device__ __forceinline__ float lbm_gate_rows(const float* r, const uint8_t* w, int ps, int c,
                                               float wt, const StepParams& p) {
  return lbm_guard(!w[c], r[3 * ps + c], r[6 * ps + c], r[7 * ps + c], p) ? wt : 0.0f;
}

__device__ __forceinline__ void lbm_pull_rows(const float* rs, const float* rj, const float* rn,
                                              int ps, const uint8_t* ws, const uint8_t* wj,
                                              const uint8_t* wn, bool ds, bool dj, bool dn,
                                              int c, const StepParams& p, float t[9]) {
  t[0] = rj[0 * ps + c];
  t[1] = rj[1 * ps + c - 1];
  t[2] = rs[2 * ps + c];
  t[3] = rj[3 * ps + c + 1];
  t[4] = rn[4 * ps + c];
  t[5] = rs[5 * ps + c - 1];
  t[6] = rs[6 * ps + c + 1];
  t[7] = rn[7 * ps + c + 1];
  t[8] = rn[8 * ps + c - 1];
  if (dj) {
    t[1] = t[1] + lbm_gate_rows(rj, wj, ps, c - 1, p.w1, p);
    t[3] = t[3] - lbm_gate_rows(rj, wj, ps, c + 1, p.w1, p);
  }
  if (ds) {
    t[5] = t[5] + lbm_gate_rows(rs, ws, ps, c - 1, p.w2, p);
    t[6] = t[6] - lbm_gate_rows(rs, ws, ps, c + 1, p.w2, p);
  }
  if (dn) {
    t[7] = t[7] - lbm_gate_rows(rn, wn, ps, c + 1, p.w2, p);
    t[8] = t[8] + lbm_gate_rows(rn, wn, ps, c - 1, p.w2, p);
  }
}

// x mod n in [0, n), for any int x and n > 0 (periodic wrap of an index
// that may lie several periods outside the grid).
__device__ __forceinline__ int lbm_wrap(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

// Butterfly sum over the 32 lanes of a warp, valid in every lane.  Each
// lane adds the same two values in the same order (a + b == b + a), so the
// result is fixed: deterministic, no atomics.
__device__ __forceinline__ float lbm_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order tree sum of one value per thread over an NT-thread block
// (run-to-run deterministic; no atomics).  Every thread of the block must
// call it; the result is valid in thread 0.
template <int NT = kThreads>
__device__ __forceinline__ float lbm_block_sum(float v, float* sh) {
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  sh[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = sh[tid] + sh[tid + s];
    __syncthreads();
  }
  const float total = sh[0];
  __syncthreads();  // sh may be reused right after
  return total;
}

// Second pass of the |u| reduction: block `row` sums partials[row][0..n)
// in a fixed order (strided per thread, then the tree) into out[row].
// Reads through L2: the persistent kernel calls it right after a grid
// barrier, on partials other blocks wrote.
__device__ __forceinline__ void lbm_reduce_row(const float* partials, int n, int row,
                                               float* out, float* sh) {
  const float* r = partials + static_cast<size_t>(row) * n;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n; b += kThreads) acc = acc + __ldcg(r + b);
  const float total = lbm_block_sum(acc, sh);
  if (threadIdx.x == 0) out[row] = total;
}

// The second pass as its own launch of one kThreads block per row of
// partials (rows of n floats): out[row] = the fixed-order sum of the row.
// A template, so that every source including this header may instantiate
// it without defining the kernel twice.
template <int = 0>
__global__ void __launch_bounds__(kThreads)
    lbm_reduce_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float sh[kThreads];
  lbm_reduce_row(partials, n, blockIdx.x, out, sh);
}

// Blocks of the persistent grid of `kernel` (NT threads a block, `smem`
// bytes of dynamic shared memory) on the current device: as many as the
// card holds at once, at most one per tile.  The shared-memory attribute
// and the occupancy are asked once per kernel, device and size and kept;
// a failed query returns its error.
template <int NT, typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int ntiles, int* blocks) {
  struct Entry {
    const void* fn;
    int device;
    size_t smem;
    int blocks;  // per card
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == fn && cache[i].device == device && cache[i].smem == smem) {
      *blocks = std::min(ntiles, cache[i].blocks);
      return cudaSuccess;
    }
  }
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (used < 64) cache[used++] = Entry{fn, device, smem, sms * per_sm};
  *blocks = std::min(ntiles, sms * per_sm);
  return cudaSuccess;
}

}  // namespace lbm
