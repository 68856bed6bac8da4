"""K4: the trapezoid K-step temporal sweep (csrc/temporal.cu) and its wrappers.

Replaces ``lbm_tpu/ops/temporal_pallas.py::_sweep_kernel`` (:169, entries
``make_sweep`` :388 and ``make_run_all`` :673), float32 state (K4) and
int16 state (K4-i16, ``storage="i16"``).  One launch advances the grid K
steps: each block loads an output tile plus a K-cell halo into shared
memory, takes K float32 levels there and writes the tile, so the state
crosses device memory once per K steps (the note at the top of
csrc/temporal.cu).  ``make_run_all`` runs whole sweeps, then the remainder
as K1 (or K1-i16) steps, as ``temporal_pallas.make_run_all`` does
(:690-696).

K4-slab (and K4-slab-i16), the same kernel's slab form, replaces
``temporal_pallas.make_slab_sweep`` (:535), the slab engine of the ca mode:
K steps of one shard's body rows from its ghost-extended slab, the K ghost
rows on each side and the body each a window with its own plane stride
(:func:`bind_slab_sweep`).  Its plain version is ``fused_torch.ca_sweep``
(int16 quantized once per sweep); its counts are ``SLAB_LAUNCHES`` and
``SLAB_LAUNCHES_I16``.

Beside the kernel:

- the plain version, :func:`run_plain`: ``fused_torch.run_sweeps``, K twin
  steps per sweep (int16: decoded once, encoded once per sweep), which the
  kernel matches bitwise on fields;
- ``LAUNCHES`` (f32) and ``LAUNCHES_I16`` (int16): the number of sweep
  launches so far, raised only where the kernel is launched.

Also here: :func:`pick_k`, the depth policy (``temporal_pallas.pick_k``
:608), and :func:`sweep_runner`, the runner K4 and K5 (ops/skew_cuda.py)
share.  A wrapper takes the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch, quant
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0
LAUNCHES_I16 = 0
SLAB_LAUNCHES = 0
SLAB_LAUNCHES_I16 = 0

THREADS = 512  # threads per K4 block (kT in csrc/temporal.cu)
# Shared memory one block may use on the H100 (227 KB).
SMEM_LIMIT = 232448
# The region a block holds (output tile + 2K halo), from the H100 table
# (PERF.md, Findings): 32 x 48 cells up to K = 4 (two float32 levels
# take 110 KB: two blocks per SM; the fastest of nine shapes at K = 2 and 4
# at 1536^2-4096^2), 48 x 64 above (one block per SM; at K = 8 the small
# tile's recompute costs more than the second block gains).
SMALL_REGION = (32, 48)
LARGE_REGION = (48, 64)


def tile(K: int) -> tuple[int, int]:
    """Output tile (rows, columns) of a K4 block at depth K."""
    rh, rw = SMALL_REGION if K <= 4 else LARGE_REGION
    return rh - 2 * K, rw - 2 * K


def smem_bytes(K: int, th: int, tw: int) -> int:
    """Dynamic shared memory of one K4 block (tile_smem in csrc/temporal.cu)."""
    rh, rw = th + 2 * K, tw + 2 * K
    return 2 * 9 * rh * rw * 4 + K * (THREADS // 32) * 4 + (rh + rw) * 4 + rh * rw + rh


def supports(params: LBMParams, K: int, storage: str = "f32") -> bool:
    """True when K4 can map a K-deep sweep of this grid: K >= 2, ny and nx
    at least 2K, and a tile that fits shared memory.  The driven row may lie
    anywhere (no accel_row >= K rule: every level injects it, halo
    included).  ``storage`` does not matter: the levels are float32."""
    quant.check_storage(storage)
    if K < 2 or params.ny < 2 * K or params.nx < 2 * K:
        return False
    th, tw = tile(K)
    return th >= 1 and tw >= 1 and smem_bytes(K, th, tw) <= SMEM_LIMIT


# pick_k's table: grids of at least this many cells sweep at PICK_K.
SWEEP_MIN_CELLS = 1024 * 1024
PICK_K = 4


def pick_k(params: LBMParams, storage: str = "f32") -> int:
    """Steps per sweep for a grid the program does not keep in L2; 1 means
    no temporal sweep (the K1 loop).  ``LBM_TEMPORAL_K`` overrides it (1
    disables), as in ``lbm_tpu``.

    From the H100 table (PERF.md §5, ``tools/kernel_times.py --sweeps``, K1
    timed in turns in the same call): K4 at K = 4 beat K1 by 10-22% at
    1024^2, 1536^2, 2048^2 and 4096^2, f32 and int16, and was the fastest
    depth there (K = 8 lost to K1 at 1536^2 and above); f32 grids below
    1024^2 stay in L2 (K2, K3) unless ``--temporal-k`` is given.

    int16 is never swept by default, though K4-i16 timed 12.6-14.3% under
    K1-i16: quantized once per sweep, the 1536^2 and 2048^2 channel scenes
    strayed 1.5-1.9% from f32 in av_vels over 2000 steps (past the checker's
    1%), where the K1-i16 loop, quantized every step, stayed at 0.44-0.55%
    (PERF.md, Findings).  ``--temporal-k`` and ``LBM_TEMPORAL_K`` still
    reach K4-i16 and K5-i16."""
    env = os.environ.get("LBM_TEMPORAL_K")
    if env:
        return int(env)
    quant.check_storage(storage)
    if storage == "i16":
        return 1
    return PICK_K if params.ny * params.nx >= SWEEP_MIN_CELLS else 1


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              K: int, storage: str = "f32"):
    """The plain version of K4 and K5: whole K-step sweeps, then single
    steps (``fused_torch.run_sweeps``)."""
    return fused_torch.run_sweeps(f, obstacles, params, num_steps, K, storage)


def sweep_runner(
    what: str,
    kind: str,
    geometry: tuple[int, int],
    count: Callable[[bool, int], None],
    params: LBMParams,
    obstacles: torch.Tensor,
    num_steps: int,
    K: int,
    storage: str,
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` on a sweep kernel:
    ``num_steps // K`` sweeps in one call of the library's
    ``lbm_<kind>_run`` (``kind`` ``trapezoid`` or ``skew``, with its two
    geometry integers), then the remainder as K1 steps.

    The two state buffers, the K1 tail's runner and the partials are
    allocated here, once; ``count(i16, launches)`` raises the kernel's
    counter.  ``f0`` is not modified.  On the card the returned state is one
    of the runner's buffers and stays valid until its next call."""
    quant.check_storage(storage)
    n_sweeps, rem = divmod(num_steps, K)
    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not fused_cuda.is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return run_plain(f, obstacles, params, num_steps, K, storage)

        return run_all_plain

    fused_cuda.check_mask(obstacles, params)
    lib = _build.load()
    dev = obstacles.device
    shape = (9, params.ny, params.nx)
    fa = torch.empty(shape, dtype=fused_cuda.STATE_DTYPES[storage], device=dev)
    fb = torch.empty_like(fa)
    nblocks = getattr(lib, f"lbm_{kind}_blocks")(params.ny, params.nx, K, *geometry)
    batch = max(1, min(fused_cuda.TOT_BATCH // K, n_sweeps))
    partials = torch.empty((batch * K, nblocks), dtype=torch.float32, device=dev)
    tail = fused_cuda.make_run_all(params, obstacles, rem, storage) if rem else None
    omega, w1, w2 = fused_torch.step_constants(params)
    i16, codec = fused_cuda.codec_arg(params, storage)
    run = getattr(lib, f"lbm_{kind}_run")

    def run_all(f):
        if fused_cuda.is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        fused_cuda.check_state(f, obstacles, params, storage)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        if n_sweeps:
            fa.copy_(f)
            rc = run(
                fa.data_ptr(), fb.data_ptr(), obstacles.data_ptr(), partials.data_ptr(),
                tot.data_ptr(), params.ny, params.nx, params.accel_row, omega, w1, w2,
                i16, fused_cuda.codec_ptr(codec), K, *geometry, n_sweeps, batch,
                torch.cuda.current_stream(dev).cuda_stream, dev.index,
            )
            _build.check(rc, what)
            count(bool(i16), n_sweeps)
            f = fb if n_sweeps % 2 else fa
        if rem:
            f, tot_rem = tail(f)
            tot[n_sweeps * K:] = tot_rem
        return f, tot

    return run_all


def _count(i16: bool, n: int) -> None:
    global LAUNCHES, LAUNCHES_I16
    if i16:
        LAUNCHES_I16 += n
    else:
        LAUNCHES += n


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32", tile_hw: tuple[int, int] | None = None):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: K4 sweeps, then K1
    steps for ``num_steps mod K`` (the signature of
    ``temporal_pallas.make_run_all``).  ``tile_hw`` overrides the output
    tile (a test makes one too large for shared memory)."""
    if not supports(params, K, storage):
        raise ValueError(f"trapezoid sweep (K={K}) cannot map a {params.ny}x{params.nx} grid")
    return sweep_runner("K4 trapezoid sweep kernel", "trapezoid", tile_hw or tile(K),
                        _count, params, obstacles, num_steps, K, storage)


def make_sweep(params: LBMParams, obstacles: torch.Tensor, K: int, storage: str = "f32"):
    """Build ``f -> (f_after_K_steps, tot_u (K,))``: one K4 launch."""
    return make_run_all(params, obstacles, K, K, storage)


def supports_shard(nloc: int, nx: int, K: int) -> bool:
    """Whether K4-slab maps a K-deep sweep of an nloc x nx shard: K >= 2,
    at least K body rows (the ghosts come from one neighbour each side) and
    a tile that fits shared memory.  Any width and any row offset: no
    128-lane rule and no ``accel_row >= K`` rule (``temporal_pallas.py``
    :520-532), as for K4."""
    if K < 2 or nloc < K or nx < 1:
        return False
    th, tw = tile(K)
    return th >= 1 and tw >= 1 and smem_bytes(K, th, tw) <= SMEM_LIMIT


def slab_plain(lo: torch.Tensor, body: torch.Tensor, hi: torch.Tensor, obst_ext: torch.Tensor,
               params: LBMParams, row_offset: int, ny_global: int, storage: str = "f32"):
    """The plain version of one K4-slab launch: ``fused_torch.ca_sweep``,
    int16 quantized once per sweep."""
    return fused_torch.ca_sweep(lo, body, hi, obst_ext, params, row_offset, ny_global, storage,
                                quantize="sweep")


def check_ext_args(lo, body, hi, obst_ext, out, tots, dtype) -> tuple[int, int, int]:
    """Validate the windows of one ca engine launch: ``body`` and ``out``
    (9, n, nx), ``lo`` / ``hi`` (9, K, nx), any plane stride, rows nx apart;
    ``obst_ext`` a contiguous (n + 2K, nx) bool slab; ``tots`` 1-D float32;
    all on one device.  Returns (n, nx, K)."""
    n, nx, K = body.shape[1], body.shape[2], lo.shape[1]
    dev = body.device
    for name, t, rows in (("lo", lo, K), ("body", body, n), ("hi", hi, K), ("out", out, n)):
        fused_cuda._check_window(name, t, rows, nx, dtype, dev)
    if (obst_ext.device != dev or obst_ext.dtype != torch.bool or not obst_ext.is_contiguous()
            or tuple(obst_ext.shape) != (n + 2 * K, nx)):
        raise ValueError(f"extended obstacle slab must be a contiguous ({n + 2 * K}, {nx}) "
                         f"bool tensor on {dev}")
    if tots.device != dev or tots.dtype != torch.float32 or tots.dim() != 1:
        raise ValueError(f"tots must be a 1-D float32 tensor on {dev}")
    return n, nx, K


def bind_plain(sweep_fn, lo, body, hi, obst_ext, out, tots, accumulate: bool = False):
    """``launch(t0)`` of a ca engine's plain version ``sweep_fn(lo, body,
    hi, obst_ext) -> (body', tot_us (K,))``: writes ``out`` and
    ``tots[t0 : t0 + K]`` (adds to them for ``accumulate``)."""
    K = lo.shape[1]

    def launch_plain(t0):
        new, tot = sweep_fn(lo, body, hi, obst_ext)
        out.copy_(new)
        if accumulate:
            tots[t0:t0 + K] += tot
        else:
            tots[t0:t0 + K] = tot

    return launch_plain


def bind_slab_sweep(params: LBMParams, lo: torch.Tensor, body: torch.Tensor, hi: torch.Tensor,
                    obst_ext: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
                    row_offset: int, ny_global: int, storage: str = "f32"):
    """Bind one K4-slab sweep to fixed buffers: returns ``launch(t0)``,
    which advances ``body`` (9, n, nx) K = ``lo.shape[1]`` steps, with the
    ghost rows ``lo`` / ``hi`` (9, K, nx) below / above it, into ``out``
    (9, n, nx), and writes the K per-level sums into ``tots[t0 : t0 + K]``.

    ``lo``, ``body``, ``hi`` and ``out`` may be windows of larger tensors
    (any plane stride, rows nx apart); ``out`` must not overlap the
    others.  ``obst_ext`` is the contiguous (n + 2K, nx) bool slab;
    ``row_offset`` the global row of body row 0 and ``ny_global`` the
    grid's rows (the driven row, and the wrap of shard 0's lower ghosts).
    Everything is checked here, once, so that a launch costs one call.  On
    CPU tensors ``launch`` runs the plain version; on CUDA tensors it
    launches the kernel or raises."""
    quant.check_storage(storage)
    n, nx, K = check_ext_args(lo, body, hi, obst_ext, out, tots,
                              fused_cuda.STATE_DTYPES[storage])
    if not supports_shard(n, nx, K):
        raise ValueError(f"K4-slab (K={K}) cannot map a {n}x{nx} shard")
    if fused_cuda.is_plain(body):
        return bind_plain(
            lambda lo_, b, hi_, ob: slab_plain(lo_, b, hi_, ob, params, row_offset, ny_global,
                                               storage),
            lo, body, hi, obst_ext, out, tots)

    lib = _build.load()
    dev = body.device
    th, tw = tile(K)
    partials = torch.empty((K, lib.lbm_trapezoid_blocks(n, nx, K, th, tw)), dtype=torch.float32,
                           device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)
    i16, codec = fused_cuda.codec_arg(params, storage)
    head = (lo.data_ptr(), lo.stride(0), body.data_ptr(), body.stride(0), hi.data_ptr(),
            hi.stride(0), obst_ext.data_ptr(), out.data_ptr(), out.stride(0),
            partials.data_ptr())
    tail = (n, nx, row_offset, ny_global, params.accel_row, omega, w1, w2, i16,
            fused_cuda.codec_ptr(codec), K, th, tw, torch.cuda.current_stream(dev).cuda_stream,
            dev.index)
    tot0, tot_n = tots.data_ptr(), tots.shape[0]

    def launch(t0):
        global SLAB_LAUNCHES, SLAB_LAUNCHES_I16
        if not 0 <= t0 <= tot_n - K:
            raise IndexError(f"steps {t0}..{t0 + K} outside tots of {tot_n}")
        rc = lib.lbm_trapezoid_slab(*head, tot0 + 4 * t0, *tail)
        _build.check(rc, "K4-slab sweep kernel")
        if i16:
            SLAB_LAUNCHES_I16 += 1
        else:
            SLAB_LAUNCHES += 1

    launch.keep = (partials, codec)  # alive while the launcher is
    return launch
