"""K6: the ghosted chunk kernel of the chunked mode (csrc/ghosted.cu) and
its wrapper.

Replaces ``lbm_tpu/ops/resident_pallas.py::_ghosted_chunk_kernel`` (:997,
entry ``make_ghosted_chunk_runner`` :1077), f32: ``chunk`` steps of one
shard with its two ghost rows frozen for the chunk, in one cooperative
launch that keeps the shard's two copies in the card's 50 MB L2; between
steps a block waits only for the blocks within one row of its cells
(:func:`shard_plan`).  Bound: 9 x 4 B read + 9 x 4 B written per cell-step
from L2 while both copies fit, plus each step's wait (see the notes at the
top of csrc/ghosted.cu and csrc/two_copy.cuh).  The result lands where the
step parity puts it, in the output buffer after an odd chunk and in the
input buffer after an even one: no launch moves the shard a second time.

Beside the kernel:

- :func:`supports_shard`, the mapping rule: two f32 copies of the shard fit
  ``resident_cuda.L2_STATE_BUDGET`` (``lbm_tpu``'s ``supports_shard`` asks
  for VMEM and 128 lanes; the kernel takes any nx);
- the plain version, :func:`chunk_plain`: ``chunk`` plain slab steps
  (``fused_torch.fused_step_slab``) with the same ghost rows each step.

Launches count in ``_build.LAUNCHES`` under ``K6``, one a chunk.  A wrapper
takes the plain version only for a tensor on the CPU.  For a CUDA tensor it
launches the kernel or raises; it never falls back (ops/_runner.py).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, _runner, fused_torch, inplace_cuda, resident_cuda
from lbm_tpu_torch.params import LBMParams


def supports_shard(nloc: int, nx: int) -> bool:
    """Whether K6 maps an nloc x nx shard: its two f32 copies fit the L2
    budget of the multi-step kernels."""
    return nloc >= 1 and resident_cuda.fits_l2(nloc, nx)


def shard_plan(n: int, nx: int, grid: int) -> list[list[tuple[int, int, int, int]]]:
    """K6's band plan (``inplace_cuda.band_plan``, one entry per block,
    the same every step): the n x nx shard's cells split evenly over
    ``grid`` blocks in bands aligned to ``resident_cuda.BAND_ALIGN`` cells,
    each waiting for the blocks whose cells lie within one row of its own
    in the step before (rows -1 and n are the frozen ghosts, which no block
    writes)."""
    return inplace_cuda.band_plan([(0, n), (0, n)], nx, grid,
                                  align=resident_cuda.BAND_ALIGN)[1:]


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
               row_offset: int, chunk: int, lib=None):
    """Bind one K6 chunk to fixed buffers: returns ``launch(t0)``, which
    advances the shard in ``f`` (9, n, nx) by ``chunk`` steps with the ghost
    rows ``lo`` / ``hi`` (9, 1, nx) frozen and writes the per-step sums into
    ``tots[t0 : t0 + chunk]``.  The two buffers ping-pong, as the K1-slab
    loop it replaces would: the result lands in ``launch.result``, ``out``
    for an odd ``chunk`` and ``f`` for an even one, the other buffer
    clobbered.  ``f`` and ``out`` must be contiguous, the ghosts may be
    windows.  On CPU tensors ``launch`` runs the plain version; on CUDA
    tensors it launches the kernel or raises.  ``lib`` is the kernel
    library (``_build.load()`` by default; ``_build.load_variant`` gives
    another version of the kernel to time)."""
    n, nx = f.shape[1], f.shape[2]
    dev = f.device
    for name, t, rows in (("f", f, n), ("lo", lo, 1), ("hi", hi, 1), ("out", out, n)):
        _runner.check_window(name, t, rows, nx, torch.float32, dev)
    if not (f.is_contiguous() and out.is_contiguous()):
        raise ValueError("K6 state buffers must be contiguous")
    _runner.check_slab("obstacle slab", obst_slab, n + 2, nx, tots, dev)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    result = out if chunk % 2 else f

    def launch_plain(t0):
        new, tot = chunk_plain(f, lo, hi, obst_slab, params, row_offset, chunk)
        result.copy_(new)
        tots[t0:t0 + chunk] = tot

    def card(lib):
        if not supports_shard(n, nx):
            raise ValueError(f"shard {n}x{nx} does not fit K6's L2 budget")
        grid = _runner.cooperative_grid(lib, "lbm_ghosted_grid", "K6", dev, n, nx)
        partials = resident_cuda.partials_buffer(shard_plan(n, nx, grid), chunk, dev)
        omega, w1, w2 = fused_torch.step_constants(params)
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (f.data_ptr(), out.data_ptr(), lo.data_ptr(), lo.stride(0), hi.data_ptr(),
                hi.stride(0), obst_slab.data_ptr(), partials.data_ptr())
        tail = (n, nx, row_offset, params.accel_row, omega, w1, w2, chunk, grid, stream,
                dev.index)
        return _build.bind(lib, "lbm_ghosted_chunk", "K6", head, tots, chunk, tail,
                           (partials, tots, f, out, lo, hi, obst_slab))

    launch = _runner.launcher(f, launch_plain, card, lib)
    launch.result = result
    return launch
