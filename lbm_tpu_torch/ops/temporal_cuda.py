"""K4: the trapezoid K-step temporal sweep (csrc/temporal.cu) and its wrappers.

Replaces ``lbm_tpu/ops/temporal_pallas.py::_sweep_kernel`` (:169, entries
``make_sweep`` :388 and ``make_run_all`` :673), float32 state (K4) and
int16 state (K4-i16, ``storage="i16"``).  One launch advances the grid K
steps: persistent blocks walk the output tiles in a fixed order, each tile
loaded with a K-cell halo into shared memory (a float32 tile's copy in
flight while the previous tile's last level runs), advanced K float32
levels there and written back, so the state crosses device memory once
per K steps (the note at the top of csrc/temporal.cu; :func:`tile_order`,
:func:`persistent_grid`, :func:`copy_path`).  ``make_run_all`` runs whole sweeps, then the remainder
as K1 (or K1-i16) steps, as ``temporal_pallas.make_run_all`` does
(:690-696).

K4-slab (and K4-slab-i16), the same kernel's slab form, replaces
``temporal_pallas.make_slab_sweep`` (:535), the slab engine of the ca mode:
K steps of one shard's body rows from its ghost-extended slab, the K ghost
rows on each side and the body each a window with its own plane stride
(:func:`bind_slab_sweep`).  Its plain version is ``fused_torch.ca_sweep``
(int16 quantized once per sweep).

Beside the kernel:

- the plain version, :func:`run_plain`: ``fused_torch.run_sweeps``, K twin
  steps per sweep (int16: decoded once, encoded once per sweep), which the
  kernel matches bitwise on fields.

Launches count in ``_build.LAUNCHES`` under ``K4`` and ``K4-i16`` (one a
sweep), ``K4-slab`` and ``K4-slab-i16``.

Also here: :func:`pick_k`, the depth policy (``temporal_pallas.pick_k``
:608), and :func:`sweep_runner`, the runner K4 and K5 (ops/skew_cuda.py)
share.  While a torch profiler records, a runner call marks its whole
sweeps with the range ``lbm.sweeps.k<K>`` and its K1 remainder with
``lbm.tail`` (``utils/timing.span``; K9's runner, ops/hbm_cuda.py, too):
the sweeps stay one library call, with no synchronize and no range a
sweep.  A wrapper takes the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises; it never falls back
(ops/_runner.py).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch

from lbm_tpu_torch.ops import _build, _runner, fused_cuda, fused_torch, quant
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.utils.timing import span

# The regions compiled into csrc/temporal.cu (LBM_TRAPEZOID_REGIONS):
# (rows, columns) -> threads per block.  Each block holds two float32
# copies of its region in shared memory: 32 x 48 (110.6 KB) leaves room
# for two blocks per SM, 48 x 64 (221 KB) for one.
REGIONS = {(32, 48): 512, (48, 64): 512}
# Shared memory one block may use on the H100 (227 KB).
SMEM_LIMIT = 232448
# The region a block holds (output tile + 2K halo) at depth K, from the
# H100 table (PERF.md §5 and Findings): 32 x 48 up to K = 4 (two
# blocks per SM; the other regions timed were slower: 40 x 48 on
# one block of 1024 threads, and 32 x 32 and 36 x 56 in an earlier form of
# the kernel), 48 x 64 above (at K = 8 the small tile's recompute costs
# more than the second block gains).
SMALL_REGION = (32, 48)
LARGE_REGION = (48, 64)


def region(K: int) -> tuple[int, int]:
    """The region (rows, columns) of a K4 block at depth K."""
    return SMALL_REGION if K <= 4 else LARGE_REGION


def tile(K: int) -> tuple[int, int]:
    """Output tile (rows, columns) of a K4 block at depth K."""
    rh, rw = region(K)
    return rh - 2 * K, rw - 2 * K


def smem_bytes(K: int, th: int, tw: int) -> int:
    """Dynamic shared memory of one K4 block (region_smem in
    csrc/temporal.cu): two float32 region buffers, the per-level per-warp
    |u| sums and the wall bytes; threads as compiled for the region (1024
    for one that is not)."""
    rh, rw = th + 2 * K, tw + 2 * K
    threads = REGIONS.get((rh, rw), 1024)
    return 2 * 9 * rh * rw * 4 + K * (threads // 32) * 4 + rh * rw


def tile_order(nrows: int, nx: int, K: int, tile_hw: tuple[int, int] | None = None,
               grid: int | None = None):
    """The tiles of one launch as the kernel walks them: a list per block of
    ``grid`` persistent blocks (one per tile when None) of ``(tile, y0,
    x0)``, where ``tile`` is the index of the tile's |u| partial (row-major
    over the tiles) and (y0, x0) its first output cell.  Block b takes tiles
    b, b + grid, b + 2 grid, ..."""
    th, tw = tile_hw or tile(K)
    ntx = -(-nx // tw)
    ntiles = ntx * -(-nrows // th)
    grid = min(ntiles, grid or ntiles)
    return [[(t, (t // ntx) * th, (t % ntx) * tw) for t in range(b, ntiles, grid)]
            for b in range(grid)]


def persistent_grid(K: int, ntiles: int, tile_hw: tuple[int, int] | None = None) -> int:
    """Blocks of the persistent grid of a K4 (or K4-slab) launch of
    ``ntiles`` tiles on the current CUDA device, as the library sizes it:
    as many as the card holds at once, at most one per tile."""
    blocks = _build.load().lbm_trapezoid_grid(K, *(tile_hw or tile(K)), ntiles)
    if blocks < 1:
        raise ValueError(f"no K4 kernel for the region of tile {tile_hw or tile(K)} at K={K}")
    return blocks


def copy_path(storage: str, nx: int, K: int, x0: int, tile_w: int, address: int = 0) -> str:
    """How a tile at column x0 brings in a region row of ``tile_w + 2K``
    cells (issue_tile and load_i16 in csrc/temporal.cu): int16 ``"loads"``
    (plain loads, decoded at the tile's start); float32 ``"elements"`` where
    the region wraps in x (4-byte copies element by element), else
    ``"quads"`` where the row's first element is 16-byte aligned (16-byte
    copies) and ``"floats"`` where it is not (4-byte copies).  ``address``
    is the byte address of the row's column 0."""
    quant.check_storage(storage)
    if storage == "i16":
        return "loads"
    xs = x0 - K
    if xs < 0 or xs + tile_w + 2 * K > nx:
        return "elements"
    return "quads" if (address + 4 * xs) % 16 == 0 else "floats"


def supports(params: LBMParams, K: int, storage: str = "f32") -> bool:
    """True when K4 can map a K-deep sweep of this grid: K >= 2, ny and nx
    at least 2K, and a tile that fits shared memory.  The driven row may lie
    anywhere (no accel_row >= K rule: every level injects it, halo
    included).  ``storage`` does not matter: the levels are float32."""
    quant.check_storage(storage)
    if K < 2 or params.ny < 2 * K or params.nx < 2 * K:
        return False
    return _tile_fits(K)


def _tile_fits(K: int) -> bool:
    th, tw = tile(K)
    return (th >= 1 and tw >= 1 and region(K) in REGIONS
            and smem_bytes(K, th, tw) <= SMEM_LIMIT)


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


def plain_runner(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32"):
    """The plain version of a sweep runner, ``f0 -> (f_final, tot_us
    (num_steps,))`` on CPU tensors: :func:`run_plain`, its whole sweeps
    inside ``lbm.sweeps.k<K>`` and its remainder's single steps inside
    ``lbm.tail``, as the card's runners mark theirs."""
    n_sweeps, rem = divmod(num_steps, K)

    def run_all_plain(f):
        with span(f"sweeps.k{K}") if n_sweeps else contextlib.nullcontext():
            f, tot = run_plain(f, obstacles, params, n_sweeps * K, K, storage)
        if rem:
            with span("tail"):
                f, tot_rem = fused_torch.run_steps(f, obstacles, params, rem, storage)
            tot = torch.cat([tot, tot_rem])
        return f, tot

    return run_all_plain


def sweep_runner(
    kernel: str,
    kind: str,
    geometry: Callable[[object], tuple[int, int]],
    params: LBMParams,
    obstacles: torch.Tensor,
    num_steps: int,
    K: int,
    storage: str,
    lib=None,
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` on a sweep kernel:
    ``num_steps // K`` sweeps in one call of the library's
    ``lbm_<kind>_run`` (``kind`` ``trapezoid`` or ``skew``, with the two
    geometry integers ``geometry(lib)`` gives on the card), counted as
    ``kernel`` (``K4`` or ``K5``, its ``-i16`` form for int16), then the
    remainder as K1 steps.

    The two state buffers, the K1 tail's runner and the partials are
    allocated here, once.  ``lib`` is the kernel library (``_build.load()``
    by default; ``_build.load_variant`` gives another version of the kernel
    to time).  ``f0`` is not modified.  On the card the returned state is
    one of the runner's buffers and stays valid until its next call."""
    quant.check_storage(storage)
    n_sweeps, rem = divmod(num_steps, K)
    kernel = _runner.form(kernel, storage)

    def card(lib):
        dev = obstacles.device
        with torch.cuda.device(dev):
            geom = tuple(geometry(lib))
        shape = (9, params.ny, params.nx)
        fa = torch.empty(shape, dtype=_runner.STATE_DTYPES[storage], device=dev)
        fb = torch.empty_like(fa)
        nblocks = getattr(lib, f"lbm_{kind}_blocks")(params.ny, params.nx, K, *geom)
        batch = max(1, min(_runner.TOT_BATCH // K, n_sweeps))
        partials = torch.empty((batch * K, nblocks), dtype=torch.float32, device=dev)
        tail = fused_cuda.make_run_all(params, obstacles, rem, storage) if rem else None
        omega, w1, w2 = fused_torch.step_constants(params)
        i16, codec = _runner.codec_arg(params, storage)

        def run_all(f):
            tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
            if n_sweeps:
                fa.copy_(f)
                with span(f"sweeps.k{K}"):
                    _build.launch(
                        lib, f"lbm_{kind}_run", kernel, fa.data_ptr(), fb.data_ptr(),
                        obstacles.data_ptr(), partials.data_ptr(), tot.data_ptr(), params.ny,
                        params.nx, params.accel_row, omega, w1, w2, i16,
                        _runner.codec_ptr(codec), K, *geom, n_sweeps, batch,
                        torch.cuda.current_stream(dev).cuda_stream, dev.index, n=n_sweeps,
                    )
                f = fb if n_sweeps % 2 else fa
            if rem:
                with span("tail"):
                    f, tot_rem = tail(f)
                tot[n_sweeps * K:] = tot_rem
            return f, tot

        return run_all

    return _runner.card_or_plain(params, obstacles,
                                 plain_runner(params, obstacles, num_steps, K, storage), card,
                                 storage, lib)


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32", tile_hw: tuple[int, int] | None = None, lib=None):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: K4 sweeps, then K1
    steps for ``num_steps mod K`` (the signature of
    ``temporal_pallas.make_run_all``).  ``tile_hw`` overrides the output
    tile (a test makes one too large for shared memory) and ``lib`` the
    kernel library (:func:`sweep_runner`)."""
    if not supports(params, K, storage):
        raise ValueError(f"trapezoid sweep (K={K}) cannot map a {params.ny}x{params.nx} grid")
    return sweep_runner("K4", "trapezoid", lambda lib: tile_hw or tile(K), params, obstacles,
                        num_steps, K, storage, lib)


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
    return _tile_fits(K)


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
        _runner.check_window(name, t, rows, nx, dtype, dev)
    _runner.check_slab("extended obstacle slab", obst_ext, n + 2 * K, nx, tots, dev)
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
                    row_offset: int, ny_global: int, storage: str = "f32",
                    tile_hw: tuple[int, int] | None = None, lib=None):
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
    launches the kernel or raises.  ``tile_hw`` and ``lib`` as for
    :func:`make_run_all`."""
    quant.check_storage(storage)
    n, nx, K = check_ext_args(lo, body, hi, obst_ext, out, tots, _runner.STATE_DTYPES[storage])
    if not supports_shard(n, nx, K):
        raise ValueError(f"K4-slab (K={K}) cannot map a {n}x{nx} shard")
    kernel = _runner.form("K4-slab", storage)

    def card(lib):
        dev = body.device
        th, tw = tile_hw or tile(K)
        partials = torch.empty((K, lib.lbm_trapezoid_blocks(n, nx, K, th, tw)),
                               dtype=torch.float32, device=dev)
        omega, w1, w2 = fused_torch.step_constants(params)
        i16, codec = _runner.codec_arg(params, storage)
        head = (lo.data_ptr(), lo.stride(0), body.data_ptr(), body.stride(0), hi.data_ptr(),
                hi.stride(0), obst_ext.data_ptr(), out.data_ptr(), out.stride(0),
                partials.data_ptr())
        tail = (n, nx, row_offset, ny_global, params.accel_row, omega, w1, w2, i16,
                _runner.codec_ptr(codec), K, th, tw, torch.cuda.current_stream(dev).cuda_stream,
                dev.index)
        return _build.bind(lib, "lbm_trapezoid_slab", kernel, head, tots, K, tail,
                           (partials, codec))

    return _runner.launcher(
        body,
        bind_plain(lambda lo_, b, hi_, ob: slab_plain(lo_, b, hi_, ob, params, row_offset,
                                                      ny_global, storage),
                   lo, body, hi, obst_ext, out, tots),
        card, lib)
