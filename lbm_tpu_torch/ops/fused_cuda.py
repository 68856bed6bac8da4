"""K1: the one-step CUDA kernel (csrc/step.cu) and its wrappers.

Replaces ``lbm_tpu/ops/fused_pallas.py::_step_kernel`` (:249, entry
``make_step`` :522) in its full-grid periodic form, with float32 state (K1)
or int16 state (K1-i16, ``storage="i16"``: B1's i16 codec, ops/quant.py).
One launch advances the whole grid one step and leaves a |u| partial per
block; a second, small launch per batch of steps reduces the partials into
per-step sums in a fixed order.

Bound: device-memory bytes, 9 x 4 B read + 9 x 4 B written per cell-step
(9 x 2 B each way for int16).  The kernel reads every plane's pulled row
segments coalesced and wraps both axes by index arithmetic, so a step is
one pass over the state with no ghost assembly (see the note at the top of
csrc/step.cu).  The int16 forms (K1-i16, K1-slab-i16) are a design of their
own for Hopper: persistent blocks, two cells a lane in adjacent columns with
32-bit accesses, a codec without conversion instructions, and one launch a
shard step (csrc/step.cu, namespace i16; PERF.md Findings).

Beside the kernel:

- the plain version, :func:`step_plain` / :func:`run_plain`: the torch twin
  (ops/fused_torch.py), which the kernel matches bitwise on fields.

K1-slab (and K1-slab-i16), the same kernel's slab form, replaces B1's
``make_slab_step`` (fused_pallas.py:581): one step of a shard's body rows
with external ghost rows and a runtime row offset, each of body, ghosts and
output a window with its own plane stride (:func:`bind_slab_step`).  Its
plain version is ``fused_torch.fused_step_slab[_i16]``.

Launches count in ``_build.LAUNCHES`` under ``K1``, ``K1-i16`` (one a
step), ``K1-slab`` and ``K1-slab-i16``.  A wrapper takes the plain version
only for a tensor on the CPU.  For a CUDA tensor it launches the kernel or
raises; it never falls back (ops/_runner.py).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, _runner, fused_torch, quant
from lbm_tpu_torch.params import LBMParams


def step_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams,
               storage: str = "f32"):
    """The plain version of one K1 launch: the twin step (int16 in and out
    for ``storage="i16"``)."""
    quant.check_storage(storage)
    if storage == "i16":
        return fused_torch.fused_step_i16(f, obstacles, params)
    return fused_torch.fused_step_single(f, obstacles, params)


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              storage: str = "f32"):
    """The plain version of a K1 loop: ``num_steps`` twin steps."""
    return fused_torch.run_steps(f, obstacles, params, num_steps, storage)


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int,
                 storage: str = "f32", lib=None):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: ``num_steps`` K1
    launches ping-ponging between two buffers, allocated here once.

    ``f0`` is not modified.  On the card the returned state is one of the
    runner's two buffers and stays valid until the runner's next call.
    ``lib`` is the kernel library (``_build.load()`` by default;
    ``_build.load_variant`` gives another version of the kernel to time)."""
    quant.check_storage(storage)
    kernel = _runner.form("K1", storage)

    def card(lib):
        dev = obstacles.device
        shape = (9, params.ny, params.nx)
        fa = torch.empty(shape, dtype=_runner.STATE_DTYPES[storage], device=dev)
        fb = torch.empty_like(fa)
        nblocks = lib.lbm_step_blocks(params.ny, params.nx)
        batch = max(1, min(_runner.TOT_BATCH, num_steps))
        partials = torch.empty((batch, nblocks), dtype=torch.float32, device=dev)
        omega, w1, w2 = fused_torch.step_constants(params)
        i16, codec = _runner.codec_arg(params, storage)

        def run_all(f):
            tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
            if num_steps == 0:
                return f, tot
            fa.copy_(f)
            _build.launch(
                lib, "lbm_step_run", kernel, fa.data_ptr(), fb.data_ptr(),
                obstacles.data_ptr(), partials.data_ptr(), tot.data_ptr(), params.ny, params.nx,
                params.accel_row, omega, w1, w2, i16, _runner.codec_ptr(codec), num_steps,
                batch, torch.cuda.current_stream(dev).cuda_stream, dev.index, n=num_steps,
            )
            return (fb if num_steps % 2 else fa), tot

        return run_all

    return _runner.card_or_plain(
        params, obstacles, lambda f: run_plain(f, obstacles, params, num_steps, storage), card,
        storage, lib)


def slab_plain(body: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               obst_slab: torch.Tensor, params: LBMParams, row_offset: int,
               storage: str = "f32") -> fused_torch.StepOutput:
    """The plain version of one K1-slab launch: the ghosted slab
    ``[lo, body, hi]`` through ``fused_torch.fused_step_slab[_i16]``."""
    quant.check_storage(storage)
    step_fn = fused_torch.fused_step_slab_i16 if storage == "i16" else fused_torch.fused_step_slab
    return step_fn(torch.cat([lo, body, hi], dim=1), obst_slab, params, row_offset)


def bind_slab_plain(params: LBMParams, body: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, obst_slab: torch.Tensor, out: torch.Tensor,
                    tots: torch.Tensor, row_offset: int, storage: str = "f32"):
    """The plain version of :func:`bind_slab_step`'s ``launch(t)``, on any
    device: the ``torch`` backend of the sharded modes binds it directly."""

    def launch_plain(t):
        new, tot = slab_plain(body, lo, hi, obst_slab, params, row_offset, storage)
        out.copy_(new)
        tots[t] = tot

    return launch_plain


def bind_slab_step(params: LBMParams, body: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   obst_slab: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
                   row_offset: int, storage: str = "f32", lib=None):
    """Bind one K1-slab step to fixed buffers: returns ``launch(t)``, which
    advances ``body`` (9, n, nx) one step, with ghost rows ``lo`` / ``hi``
    (9, 1, nx) below / above it, into ``out`` (9, n, nx), and writes the
    slab's tot_u into ``tots[t]``.

    ``body``, ``lo``, ``hi`` and ``out`` may be windows of larger tensors
    (any plane stride, rows nx apart); ``obst_slab`` is the contiguous
    (n + 2, nx) bool mask with its ghost rows; ``row_offset`` the global row
    of body row 0.  Everything is checked here, once, so that the launch
    itself costs one call.  The launches go to the stream that is current
    here, at binding (so a loop bound while a CUDA graph captures lands in
    the graph).  On CPU tensors ``launch`` runs the plain version; on CUDA
    tensors it launches the kernel or raises.  ``lib`` as for
    :func:`make_run_all`."""
    quant.check_storage(storage)
    n, nx = body.shape[1], body.shape[2]
    dev, dtype = body.device, _runner.STATE_DTYPES[storage]
    for name, t, rows in (("body", body, n), ("lo", lo, 1), ("hi", hi, 1), ("out", out, n)):
        _runner.check_window(name, t, rows, nx, dtype, dev)
    _runner.check_slab("obstacle slab", obst_slab, n + 2, nx, tots, dev)
    kernel = _runner.form("K1-slab", storage)

    def card(lib):
        # Word 0: the int16 kernel's ticket counter, zero between launches.
        partials = torch.zeros(lib.lbm_step_blocks(n, nx) + 1, dtype=torch.float32, device=dev)
        omega, w1, w2 = fused_torch.step_constants(params)
        i16, codec = _runner.codec_arg(params, storage)
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (body.data_ptr(), body.stride(0), lo.data_ptr(), lo.stride(0), hi.data_ptr(),
                hi.stride(0), obst_slab.data_ptr(), out.data_ptr(), out.stride(0),
                partials.data_ptr())
        tail = (n, nx, row_offset, params.accel_row, omega, w1, w2, i16,
                _runner.codec_ptr(codec), stream, dev.index)
        return _build.bind(lib, "lbm_slab_step", kernel, args, tots, 1, tail,
                           (partials, codec, tots, body, lo, hi, obst_slab, out))

    return _runner.launcher(
        body, bind_slab_plain(params, body, lo, hi, obst_slab, out, tots, row_offset, storage),
        card, lib)


def make_slab_step(params: LBMParams, storage: str = "f32"):
    """``lbm_tpu``'s ``make_slab_step`` interface:
    ``(slab (9, n+2, nx), obst_slab (n+2, nx), row_offset) -> (f (9, n, nx),
    tot_u)``, through K1-slab on a CUDA tensor and its plain version on a
    CPU one.  Binds anew at every call: the sharded modes bind once
    (:func:`bind_slab_step`)."""

    def step_slab(slab, obst_slab, row_offset):
        n = slab.shape[1] - 2
        out = torch.empty((9, n, slab.shape[2]), dtype=slab.dtype, device=slab.device)
        tots = torch.empty(1, dtype=torch.float32, device=slab.device)
        bind_slab_step(params, slab[:, 1:-1], slab[:, :1], slab[:, -1:], obst_slab, out, tots,
                       row_offset, storage)(0)
        return fused_torch.StepOutput(out, tots[0])

    return step_slab


def step(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams,
         storage: str = "f32") -> fused_torch.StepOutput:
    """One step: ``f -> (f_new, tot_u)``.  K1 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if _runner.is_plain(f):
        return step_plain(f, obstacles, params, storage)
    f_new, tot = make_run_all(params, obstacles, 1, storage)(f)
    return fused_torch.StepOutput(f_new, tot[0])
