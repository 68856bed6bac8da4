"""K7 and K8: the resident and in-place sweeps of the ca mode
(csrc/ca_resident.cu, csrc/ca_inplace.cu) and their wrappers.

The exact communication-avoiding mode (ca, parallel/modes.py) exchanges K
ghost rows per shard once per K steps and advances each shard K steps in
one sweep of its ghost-extended slab ``[lo | body | hi]``; the body after
the sweep is K synchronous exchanged steps, bitwise.  Three engines sweep
it: K4-slab (ops/temporal_cuda.py), and the two here.

- **K7** replaces ``lbm_tpu/ops/resident_pallas.py::_ca_ext_kernel``
  (:1192, entry ``make_ca_chunk_runner`` :1241), f32: one cooperative
  launch per sweep, the extended slab ping-ponging between two scratch
  copies in the card's 50 MB L2 with a grid barrier per step (K2's and
  K6's structure).  Maps where the two copies fit
  ``resident_cuda.L2_STATE_BUDGET`` (:func:`supports_resident`).
- **K8** (f32) and **K8-i16** replace ``_ca_inplace_kernel`` (:1643, body
  ``_inplace_slab_sweep`` :1474, entry ``make_ca_inplace_runner`` :1676):
  one cooperative launch per sweep on ONE scratch copy of the slab, in K3's
  AA in-place pattern; int16 is quantized every step, as B10 does.  Maps
  where one copy of the extended slab fits ``inplace_cuda.L2_INPLACE_BUDGET``
  (in the state's own bytes), and ext <= ny (one image of the driven row
  in the slab).  A taller shard runs as ``parts`` sub-slabs
  (:func:`inplace_parts`, ``ca_inplace_parts`` :1436), each a K8 launch
  whose K-deep ghosts are windows of the neighbouring sub-slabs' pre-sweep
  rows; the launches add their |u| into the shard's sums in part order.

Bound: 9 x 4 B (int16: 2 B) read + written per cell-step of the extended
slab, from L2 while it fits, plus one grid barrier per step (see the notes
at the top of the two sources).

Beside the kernels:

- the plain version, :func:`sweep_plain`: ``fused_torch.ca_sweep``, K
  periodic steps of the extended slab (int16 quantized per step for K8),
  which the kernels match bitwise on the body's fields;
- ``RESIDENT_LAUNCHES`` (K7), ``INPLACE_LAUNCHES`` and
  ``INPLACE_LAUNCHES_I16`` (K8, one per sub-slab): raised only where a
  kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import (
    _build,
    fused_cuda,
    fused_torch,
    inplace_cuda,
    quant,
    resident_cuda,
    temporal_cuda,
)
from lbm_tpu_torch.ops.temporal_cuda import bind_plain, check_ext_args
from lbm_tpu_torch.params import LBMParams

RESIDENT_LAUNCHES = 0
INPLACE_LAUNCHES = 0
INPLACE_LAUNCHES_I16 = 0


def supports_resident(nloc: int, nx: int, K: int) -> bool:
    """Whether K7 maps a K-deep sweep of an nloc x nx shard: K >= 2, at
    least K body rows, and two f32 copies of the (nloc + 2K, nx) extended
    slab within ``resident_cuda.L2_STATE_BUDGET``.  Any width (no 128-lane
    or 8-row rule, ``supports_ca_shard`` :1166)."""
    return K >= 2 and nloc >= K and nx >= 1 and resident_cuda.fits_l2(nloc + 2 * K, nx)


def inplace_maps_whole(nloc: int, nx: int, K: int, ny_global: int, storage: str = "f32") -> bool:
    """Whether one K8 launch maps an nloc x nx (sub-)slab: K >= 2, at least
    K body rows, ext = nloc + 2K <= ny_global (at most one image of the
    driven row in the slab: one guard row), and one copy of the extended
    slab, in the state's bytes, within ``inplace_cuda.L2_INPLACE_BUDGET``
    (36 MiB, both storages)."""
    ext = nloc + 2 * K
    return (K >= 2 and nloc >= K and nx >= 1 and ext <= ny_global
            and inplace_cuda.state_bytes(ext, nx, storage) <= inplace_cuda.L2_INPLACE_BUDGET)


def inplace_parts(nloc: int, nx: int, K: int, ny_global: int, storage: str = "f32") -> int | None:
    """Sub-slabs of the in-place sweep (``ca_inplace_parts`` :1436): 1 when
    the whole shard maps, else the smallest count that divides nloc into
    sub-slabs that map, None when none does."""
    for parts in range(1, nloc // max(K, 1) + 1):
        if nloc % parts == 0 and inplace_maps_whole(nloc // parts, nx, K, ny_global, storage):
            return parts
    return None


def parts_valid(nloc: int, nx: int, K: int, ny_global: int, parts: int) -> bool:
    """Whether a forced split (``LBM_CA_PARTS``) is one K8 can run: parts
    divides nloc into sub-slabs of at least K rows (their ghosts come from
    one neighbour each side) whose extended slab holds at most one image of
    the driven row.  The L2 budget is not asked: a forced split may leave
    L2 (slower, not wrong)."""
    if parts < 1 or nloc % parts:
        return False
    sub = nloc // parts
    return K >= 2 and sub >= K and sub + 2 * K <= ny_global


def driven_ext_row(accel_row: int, row_offset: int, K: int, n: int, ny_global: int) -> int:
    """The extended row e of the driven row in the slab of a body of n rows
    at ``row_offset`` (global row ``(row_offset - K + e) mod ny_global``),
    or -1 when the slab holds none; with ext <= ny_global there is at most
    one."""
    e = (accel_row - (row_offset - K)) % ny_global
    return e if e < n + 2 * K else -1


def sweep_plain(lo: torch.Tensor, body: torch.Tensor, hi: torch.Tensor, obst_ext: torch.Tensor,
                params: LBMParams, row_offset: int, ny_global: int, storage: str = "f32"):
    """The plain version of one K7 or K8 launch: ``fused_torch.ca_sweep``,
    int16 quantized every step (K8-i16)."""
    return fused_torch.ca_sweep(lo, body, hi, obst_ext, params, row_offset, ny_global, storage,
                                quantize="step")


def bind_resident(params: LBMParams, lo: torch.Tensor, body: torch.Tensor, hi: torch.Tensor,
                  obst_ext: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
                  row_offset: int, ny_global: int):
    """Bind one K7 sweep to fixed buffers: returns ``launch(t0)``, which
    advances ``body`` (9, n, nx) K = ``lo.shape[1]`` steps, with the ghost
    rows ``lo`` / ``hi`` (9, K, nx), into ``out``, and writes the K
    per-level sums into ``tots[t0 : t0 + K]``; arguments as
    ``temporal_cuda.bind_slab_sweep``, f32 only.  On CPU tensors ``launch``
    runs the plain version; on CUDA tensors it launches the kernel or
    raises."""
    n, nx, K = check_ext_args(lo, body, hi, obst_ext, out, tots, torch.float32)
    if not supports_resident(n, nx, K):
        raise ValueError(f"K7 (K={K}) cannot map a {n}x{nx} shard: two copies of its "
                         "extended slab do not fit the L2 budget")
    if fused_cuda.is_plain(body):
        return bind_plain(
            lambda lo_, b, hi_, ob: sweep_plain(lo_, b, hi_, ob, params, row_offset, ny_global),
            lo, body, hi, obst_ext, out, tots)

    lib = _build.load()
    dev = body.device
    ext = n + 2 * K
    grid = lib.lbm_ca_resident_grid(ext, nx, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K7 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}")
    scratch = torch.empty((2, 9, ext, nx), dtype=torch.float32, device=dev)
    partials = torch.empty((K, grid), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)
    head = (lo.data_ptr(), lo.stride(0), body.data_ptr(), body.stride(0), hi.data_ptr(),
            hi.stride(0), scratch[0].data_ptr(), scratch[1].data_ptr(), obst_ext.data_ptr(),
            out.data_ptr(), out.stride(0), partials.data_ptr())
    tail = (n, nx, K, row_offset, ny_global, params.accel_row, omega, w1, w2, grid,
            torch.cuda.current_stream(dev).cuda_stream, dev.index)
    tot0, tot_n = tots.data_ptr(), tots.shape[0]

    def launch(t0):
        global RESIDENT_LAUNCHES
        if not 0 <= t0 <= tot_n - K:
            raise IndexError(f"steps {t0}..{t0 + K} outside tots of {tot_n}")
        rc = lib.lbm_ca_resident(*head, tot0 + 4 * t0, *tail)
        _build.check(rc, "K7 ca resident kernel")
        RESIDENT_LAUNCHES += 1

    launch.keep = (scratch, partials)  # alive while the launcher is
    return launch


def bind_inplace(params: LBMParams, lo: torch.Tensor, body: torch.Tensor, hi: torch.Tensor,
                 obst_ext: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
                 row_offset: int, ny_global: int, storage: str = "f32",
                 accumulate: bool = False):
    """Bind one K8 sweep (one sub-slab of a split shard, or a whole shard)
    to fixed buffers: returns ``launch(t0)``, as :func:`bind_resident`,
    f32 or int16; ``accumulate`` adds the per-level sums to
    ``tots[t0 : t0 + K]`` instead of writing them (the later sub-slabs of a
    split, in part order).  The K8 constraints of :func:`parts_valid` are
    checked, not the L2 budget.  On CPU tensors ``launch`` runs the plain
    version; on CUDA tensors it launches the kernel or raises."""
    quant.check_storage(storage)
    n, nx, K = check_ext_args(lo, body, hi, obst_ext, out, tots,
                              fused_cuda.STATE_DTYPES[storage])
    if not parts_valid(n, nx, K, ny_global, 1):
        raise ValueError(f"K8 (K={K}) cannot map a {n}x{nx} slab of a {ny_global}-row grid")
    if fused_cuda.is_plain(body):
        return bind_plain(
            lambda lo_, b, hi_, ob: sweep_plain(lo_, b, hi_, ob, params, row_offset, ny_global,
                                                storage),
            lo, body, hi, obst_ext, out, tots, accumulate)

    lib = _build.load()
    dev = body.device
    ext = n + 2 * K
    i16, codec = fused_cuda.codec_arg(params, storage)
    grid = lib.lbm_ca_inplace_grid(ext, nx, i16, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K8 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}")
    scratch = torch.empty((9, ext, nx), dtype=fused_cuda.STATE_DTYPES[storage], device=dev)
    gate = torch.empty((2, nx), dtype=torch.uint8, device=dev)
    partials = torch.empty((K, grid), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)
    head = (lo.data_ptr(), lo.stride(0), body.data_ptr(), body.stride(0), hi.data_ptr(),
            hi.stride(0), scratch.data_ptr(), gate.data_ptr(), obst_ext.data_ptr(),
            out.data_ptr(), out.stride(0), partials.data_ptr())
    tail = (n, nx, K, driven_ext_row(params.accel_row, row_offset, K, n, ny_global),
            int(accumulate), params.accel_row, omega, w1, w2, i16, fused_cuda.codec_ptr(codec),
            grid, torch.cuda.current_stream(dev).cuda_stream, dev.index)
    tot0, tot_n = tots.data_ptr(), tots.shape[0]

    def launch(t0):
        global INPLACE_LAUNCHES, INPLACE_LAUNCHES_I16
        if not 0 <= t0 <= tot_n - K:
            raise IndexError(f"steps {t0}..{t0 + K} outside tots of {tot_n}")
        rc = lib.lbm_ca_inplace(*head, tot0 + 4 * t0, *tail)
        _build.check(rc, "K8 ca in-place kernel")
        if i16:
            INPLACE_LAUNCHES_I16 += 1
        else:
            INPLACE_LAUNCHES += 1

    launch.keep = (scratch, gate, partials, codec)  # alive while the launcher is
    return launch


def bind_sweep(engine: str, params: LBMParams, lo: torch.Tensor, body: torch.Tensor,
               hi: torch.Tensor, obst_ext: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
               row_offset: int, ny_global: int, storage: str = "f32", parts: int = 1):
    """The launches of one ca sweep of a shard on ``engine`` (``slab``:
    K4-slab, ``resident``: K7, ``inplace``: K8), each ``launch(t0)``; the
    in-place engine over ``parts`` sub-slabs, whose inner ghosts are
    windows of the neighbouring sub-slabs' rows of ``body`` and whose |u|
    adds up in part order (``make_ca_inplace_runner``'s split, :1719-1767)."""
    if engine == "slab":
        return [temporal_cuda.bind_slab_sweep(params, lo, body, hi, obst_ext, out, tots,
                                              row_offset, ny_global, storage)]
    if engine == "resident":
        return [bind_resident(params, lo, body, hi, obst_ext, out, tots, row_offset, ny_global)]
    K, sub = lo.shape[1], body.shape[1] // parts
    return [bind_inplace(params, lo if i == 0 else body[:, i * sub - K:i * sub],
                         body[:, i * sub:(i + 1) * sub],
                         hi if i == parts - 1 else body[:, (i + 1) * sub:(i + 1) * sub + K],
                         obst_ext[i * sub:(i + 1) * sub + 2 * K], out[:, i * sub:(i + 1) * sub],
                         tots, row_offset + i * sub, ny_global, storage, accumulate=i > 0)
            for i in range(parts)]
