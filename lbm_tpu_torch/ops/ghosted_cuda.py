"""K6: the ghosted chunk kernel of the chunked mode (csrc/ghosted.cu) and
its wrapper.

Replaces ``lbm_tpu/ops/resident_pallas.py::_ghosted_chunk_kernel`` (:997,
entry ``make_ghosted_chunk_runner`` :1077), f32: ``chunk`` steps of one
shard with its two ghost rows frozen for the chunk, in one cooperative
launch that keeps the shard's two copies in the card's 50 MB L2, with the
ghosts' driven-row injection computed once.  Bound: 9 x 4 B read + 9 x 4 B
written per cell-step from L2 while both copies fit, plus one grid barrier
per step (see the note at the top of csrc/ghosted.cu).

Beside the kernel:

- :func:`supports_shard`, the mapping rule: two f32 copies of the shard fit
  ``resident_cuda.L2_STATE_BUDGET`` (``lbm_tpu``'s ``supports_shard`` asks
  for VMEM and 128 lanes; the kernel takes any nx);
- the plain version, :func:`chunk_plain`: ``chunk`` plain slab steps
  (``fused_torch.fused_step_slab``) with the same ghost rows each step;
- ``LAUNCHES``: the number of chunk launches so far, raised only where the
  kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch, resident_cuda
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0


def supports_shard(nloc: int, nx: int) -> bool:
    """Whether K6 maps an nloc x nx shard: its two f32 copies fit the L2
    budget of the multi-step kernels."""
    return nloc >= 1 and resident_cuda.fits_l2(nloc, nx)


def chunk_plain(f: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, obst_slab: torch.Tensor,
                params: LBMParams, row_offset: int, chunk: int):
    """The plain version of one K6 launch: ``chunk`` slab steps of ``f``
    (9, n, nx) with the ghost rows ``lo`` / ``hi`` frozen; returns
    (f', tot_us (chunk,))."""
    tots = torch.empty(chunk, dtype=torch.float32, device=f.device)
    for t in range(chunk):
        f, tots[t] = fused_torch.fused_step_slab(torch.cat([lo, f, hi], dim=1), obst_slab,
                                                 params, row_offset)
    return f, tots


def bind_chunk(params: LBMParams, f: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               obst_slab: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
               row_offset: int, chunk: int):
    """Bind one K6 chunk to fixed buffers: returns ``launch(t0)``, which
    advances the shard in ``f`` (9, n, nx) by ``chunk`` steps with the ghost
    rows ``lo`` / ``hi`` (9, 1, nx) frozen, leaves the result in ``out``
    and writes the per-step sums into ``tots[t0 : t0 + chunk]``.  On the
    card ``f`` is clobbered (the kernel's second copy), as the K1-slab loop
    it replaces would overwrite it; ``f`` and ``out`` must be contiguous,
    the ghosts may be windows.  On CPU tensors ``launch`` runs the plain
    version; on CUDA tensors it launches the kernel or raises."""
    n, nx = f.shape[1], f.shape[2]
    dev = f.device
    for name, t, rows in (("f", f, n), ("lo", lo, 1), ("hi", hi, 1), ("out", out, n)):
        fused_cuda._check_window(name, t, rows, nx, torch.float32, dev)
    if not (f.is_contiguous() and out.is_contiguous()):
        raise ValueError("K6 state buffers must be contiguous")
    if (obst_slab.device != dev or obst_slab.dtype != torch.bool
            or not obst_slab.is_contiguous() or tuple(obst_slab.shape) != (n + 2, nx)):
        raise ValueError(f"obstacle slab must be a contiguous ({n + 2}, {nx}) bool tensor on "
                         f"{dev}")
    if tots.device != dev or tots.dtype != torch.float32 or tots.dim() != 1:
        raise ValueError(f"tots must be a 1-D float32 tensor on {dev}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    if fused_cuda.is_plain(f):

        def launch_plain(t0):
            new, tot = chunk_plain(f, lo, hi, obst_slab, params, row_offset, chunk)
            out.copy_(new)
            tots[t0:t0 + chunk] = tot

        return launch_plain

    if not supports_shard(n, nx):
        raise ValueError(f"shard {n}x{nx} does not fit K6's L2 budget")
    lib = _build.load()
    grid = lib.lbm_ghosted_grid(n, nx, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K6 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}")
    gscr = torch.empty((2, 9, nx), dtype=torch.float32, device=dev)
    partials = torch.empty((chunk, grid), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (f.data_ptr(), out.data_ptr(), lo.data_ptr(), lo.stride(0), hi.data_ptr(),
            hi.stride(0), gscr.data_ptr(), obst_slab.data_ptr(), partials.data_ptr())
    tail = (n, nx, row_offset, params.accel_row, omega, w1, w2, chunk, grid, stream, dev.index)
    tot0, tot_n = tots.data_ptr(), tots.shape[0]

    def launch(t0):
        global LAUNCHES
        if not 0 <= t0 <= tot_n - chunk:
            raise IndexError(f"steps {t0}..{t0 + chunk} outside tots of {tot_n}")
        rc = lib.lbm_ghosted_chunk(*head, tot0 + 4 * t0, *tail)
        _build.check(rc, "K6 ghosted chunk kernel")
        LAUNCHES += 1

    launch.keep = (gscr, partials)  # alive while the launcher is
    return launch
