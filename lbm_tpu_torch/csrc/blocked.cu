// K10: the two-copy row-block persistent kernel for Hopper.
//
// Replaces the TPU kernel lbm_tpu/ops/resident_pallas.py::_blocked_chunk_kernel
// (:480, built by make_chunk_runner :766 -> pallas_call :882): `chunk` steps in
// one launch, the state ping-ponging between two whole-grid copies, each step
// walked as row blocks of B rows that read the periodic shifted windows
// [r0 - cy, r0 + B - cy) of the source, with the driven row replaced by its
// accel-adjusted row `adj`, computed once per step.
//
// On the TPU both copies sat in VMEM and Mosaic walked the row blocks one
// after another.  Here the copies live in device memory (both stay in the
// 50 MB L2 up to 768^2; at 1024^2 they take 72 MiB and stream from HBM), the
// launch is cooperative and persistent with a grid barrier between steps (as
// K2), and the unit of work is a tile of B rows x W columns (B * W = kThreads,
// one cell per thread) that blocks stride over.  A tile pulls its cells
// straight from the source copy: streaming is a permutation, so every source
// value is read by exactly one destination cell and staging the windows in
// shared memory would give no reuse.
//
// The driven row: the thread that writes cell (accel_row, c) of step t also
// writes the accel-adjusted values of that cell (the guarded injection of
// SerialCode/d2q9-bgk.c:216-246, from its new values) into adj[(t+1) % 2];
// step t + 1 reads speeds 1, 3 (row accel_row), 5, 6 (the row above it) and
// 7, 8 (the row below it) from there instead of recomputing the guard per
// pulling cell.  Step 0 takes adj[0] from a prologue before the first barrier.
//
// |u|: a tile sums its cells' |u| over its B rows in row order (through
// shared memory) into its W-column slice of part[t % 2] (nby x nx).  At the
// start of step t + 1 (after the barrier) each column of part[t % 2] is summed
// over the row blocks in block order into colsum[t] (chunk x nx); the ring of
// two part buffers never grows with the chunk.  After the last step, one more
// barrier, and block b sums rows b, b + grid, ... of colsum in the fixed order
// of lbm_reduce_row into tot_out.  No float atomics.  The plain version
// (ops/fused_torch.py blocked_chunk) takes the same grouping.
//
// The ping-pong buffers, adj and the partials are written and read in the
// same launch, so every read of them goes through L2 (__ldcg), never the
// non-coherent per-SM caches.
//
// __launch_bounds__(256, 4): 64 registers (80 without it) and four blocks per
// SM instead of three, 7-9% faster at 512^2-1024^2 on the H100 (PERF.md,
// Findings, K10).

#include <cooperative_groups.h>

#include "lbm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The accel-adjusted values of one driven-row cell from its values v[0..9)
// and its wall byte, into adj[k * nx + c] for the speeds a pull reads from
// the driven row (1, 3, 5, 6, 7, 8).
__device__ __forceinline__ void lbm_store_adj(const float v[9], bool wall, int c, float* adj,
                                              const lbm::StepParams& p) {
  const bool ok = lbm::lbm_guard(!wall, v[3], v[6], v[7], p);
  const float d1 = ok ? p.w1 : 0.0f;
  const float d2 = ok ? p.w2 : 0.0f;
  const size_t nx = static_cast<size_t>(p.nx);
  adj[1 * nx + c] = v[1] + d1;
  adj[3 * nx + c] = v[3] - d1;
  adj[5 * nx + c] = v[5] + d2;
  adj[6 * nx + c] = v[6] - d2;
  adj[7 * nx + c] = v[7] - d2;
  adj[8 * nx + c] = v[8] + d2;
}

__global__ void __launch_bounds__(lbm::kThreads, 4)
    lbm_blocked_kernel(float* fa, float* fb, const uint8_t* obst, float* adj, float* part,
                       float* colsum, float* tot_out, lbm::StepParams p, int chunk, int B) {
  __shared__ float sh[lbm::kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, ny = p.ny, ar = p.accel_row;
  const size_t plane = static_cast<size_t>(ny) * nx;
  const size_t adj_stride = 9 * static_cast<size_t>(nx);
  const int W = lbm::kThreads / B;
  const int nby = (ny + B - 1) / B;
  const int nbx = (nx + W - 1) / W;
  const int ntiles = nby * nbx;
  const size_t part_size = static_cast<size_t>(nby) * nx;
  const int ty = threadIdx.x / W;
  const int tx = threadIdx.x - ty * W;
  // The per-column passes run on the last blocks, which hold no tile or
  // the fewest (tiles go round-robin from block 0, and the grid has a
  // block per 256 columns more than tiles where the card holds it), so
  // their chain of ny / B loads stays off the barrier's critical path.
  const int gtid = (gridDim.x - 1 - blockIdx.x) * lbm::kThreads + threadIdx.x;
  const int gthreads = gridDim.x * lbm::kThreads;

  // Prologue: adj[0] from the driven row of the launch's source state.
  for (int c = gtid; c < nx; c += gthreads) {
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = __ldcg(fa + k * plane + static_cast<size_t>(ar) * nx + c);
    lbm_store_adj(v, obst[static_cast<size_t>(ar) * nx + c] != 0, c, adj, p);
  }
  grid.sync();

  for (int t = 0; t < chunk; ++t) {
    const float* src = (t % 2 == 0) ? fa : fb;
    float* dst = (t % 2 == 0) ? fb : fa;
    const float* a_in = adj + (t % 2) * adj_stride;
    float* a_out = adj + ((t + 1) % 2) * adj_stride;
    float* p_out = part + (t % 2) * part_size;

    // Step t - 1's column sums over the row blocks, in block order.
    if (t > 0) {
      const float* p_in = part + ((t - 1) % 2) * part_size;
      for (int c = gtid; c < nx; c += gthreads) {
        float s = 0.0f;
#pragma unroll 16
        for (int b = 0; b < nby; ++b) s = s + __ldcg(p_in + static_cast<size_t>(b) * nx + c);
        colsum[static_cast<size_t>(t - 1) * nx + c] = s;
      }
    }

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int by = tile / nbx;
      const int bx = tile - by * nbx;
      const int j = by * B + ty;
      const int i = bx * W + tx;
      float speed = 0.0f;
      if (j < ny && i < nx) {
        const int js = (j == 0) ? ny - 1 : j - 1;  // source row of cy = +1
        const int jn = (j + 1 == ny) ? 0 : j + 1;  // source row of cy = -1
        const int iw = (i == 0) ? nx - 1 : i - 1;  // source column of cx = +1
        const int ie = (i + 1 == nx) ? 0 : i + 1;  // source column of cx = -1
        const size_t rj = static_cast<size_t>(j) * nx;
        const size_t rs = static_cast<size_t>(js) * nx;
        const size_t rn = static_cast<size_t>(jn) * nx;
        float tv[9], out[9];
        tv[0] = __ldcg(src + 0 * plane + rj + i);
        tv[2] = __ldcg(src + 2 * plane + rs + i);
        tv[4] = __ldcg(src + 4 * plane + rn + i);
        if (j == ar) {
          tv[1] = __ldcg(a_in + 1 * nx + iw);
          tv[3] = __ldcg(a_in + 3 * nx + ie);
        } else {
          tv[1] = __ldcg(src + 1 * plane + rj + iw);
          tv[3] = __ldcg(src + 3 * plane + rj + ie);
        }
        if (js == ar) {
          tv[5] = __ldcg(a_in + 5 * nx + iw);
          tv[6] = __ldcg(a_in + 6 * nx + ie);
        } else {
          tv[5] = __ldcg(src + 5 * plane + rs + iw);
          tv[6] = __ldcg(src + 6 * plane + rs + ie);
        }
        if (jn == ar) {
          tv[7] = __ldcg(a_in + 7 * nx + ie);
          tv[8] = __ldcg(a_in + 8 * nx + iw);
        } else {
          tv[7] = __ldcg(src + 7 * plane + rn + ie);
          tv[8] = __ldcg(src + 8 * plane + rn + iw);
        }
        const bool wall = obst[rj + i] != 0;
        speed = lbm::lbm_collide(tv, wall, p.omega, out);
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = out[k];
        if (j == ar) lbm_store_adj(out, wall, i, a_out, p);
      }
      // The tile's column partials: its B rows summed in row order.
      sh[threadIdx.x] = speed;
      __syncthreads();
      if (ty == 0 && i < nx) {
        float acc = 0.0f;
        for (int r = 0; r < B && by * B + r < ny; ++r) acc = acc + sh[r * W + tx];
        p_out[static_cast<size_t>(by) * nx + i] = acc;
      }
      __syncthreads();
    }
    grid.sync();
  }

  // The last step's column sums, then each step's sum over the columns.
  if (chunk > 0) {
    const float* p_in = part + ((chunk - 1) % 2) * part_size;
    for (int c = gtid; c < nx; c += gthreads) {
      float s = 0.0f;
#pragma unroll 16
      for (int b = 0; b < nby; ++b) s = s + __ldcg(p_in + static_cast<size_t>(b) * nx + c);
      colsum[static_cast<size_t>(chunk - 1) * nx + c] = s;
    }
  }
  grid.sync();
  for (int t = blockIdx.x; t < chunk; t += gridDim.x) {
    lbm::lbm_reduce_row(colsum, nx, t, tot_out, sh);
  }
}

}  // namespace

extern "C" {

// Blocks of one cooperative launch over the tiles of B rows x kThreads / B
// columns: one per tile and one per kThreads columns for the column passes,
// and no more than can be resident on the device at once (a larger
// cooperative launch is refused).  Returns <= 0 on error, or for a B that
// does not divide kThreads.
int lbm_blocked_grid(int ny, int nx, int block_rows, int device) {
  if (block_rows < 1 || lbm::kThreads % block_rows) return -1;
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_blocked_kernel, lbm::kThreads,
                                                    0) != cudaSuccess)
    return -1;
  const int W = lbm::kThreads / block_rows;
  const long long want = static_cast<long long>((ny + block_rows - 1) / block_rows) *
                             ((nx + W - 1) / W) +
                         (nx + lbm::kThreads - 1) / lbm::kThreads;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < cap ? want : cap);
}

// Run `chunk` steps in one cooperative launch of `grid` blocks (from
// lbm_blocked_grid) with row blocks of `block_rows`.  The state starts in fa
// and ends in fb for odd chunk, in fa for even.  adj holds 2 x 9 x nx
// floats, part 2 x ceil(ny / block_rows) x nx, colsum chunk x nx; tot_out
// receives chunk per-step sums.  Returns the launch's error code, or
// cudaGetLastError().
int lbm_blocked_chunk(float* fa, float* fb, const uint8_t* obst, float* adj, float* part,
                      float* colsum, float* tot_out, int ny, int nx, int accel_row, float omega,
                      float w1, float w2, int chunk, int block_rows, int grid, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || grid < 1 || block_rows < 1 || lbm::kThreads % block_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  lbm::StepParams p{ny, nx, accel_row, omega, w1, w2};
  void* args[] = {&fa, &fb, &obst, &adj, &part, &colsum, &tot_out, &p, &chunk, &block_rows};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_blocked_kernel),
                                    dim3(grid), dim3(lbm::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
