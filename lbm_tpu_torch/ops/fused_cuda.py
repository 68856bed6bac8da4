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
csrc/step.cu).

Beside the kernel:

- the plain version, :func:`step_plain` / :func:`run_plain`: the torch twin
  (ops/fused_torch.py), which the kernel matches bitwise on fields;
- ``LAUNCHES`` (f32) and ``LAUNCHES_I16`` (int16): the number of step-kernel
  launches so far, raised only where the kernel is launched.

K1-slab (and K1-slab-i16), the same kernel's slab form, replaces B1's
``make_slab_step`` (fused_pallas.py:581): one step of a shard's body rows
with external ghost rows and a runtime row offset, each of body, ghosts and
output a window with its own plane stride (:func:`bind_slab_step`).  Its
plain version is ``fused_torch.fused_step_slab[_i16]``; its counts are
``SLAB_LAUNCHES`` and ``SLAB_LAUNCHES_I16``.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, fused_torch, quant
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0
LAUNCHES_I16 = 0
SLAB_LAUNCHES = 0
SLAB_LAUNCHES_I16 = 0

# Steps whose per-block |u| partials are held before one reduce launch turns
# them into per-step sums (bounds the partials buffer at 256 x blocks floats).
TOT_BATCH = 256

STATE_DTYPES = {"f32": torch.float32, "i16": torch.int16}


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


def check_mask(obstacles: torch.Tensor, params: LBMParams) -> None:
    """Validate a CUDA obstacle mask for the kernels: (ny, nx) bool, contiguous."""
    if obstacles.device.type != "cuda":
        raise ValueError(f"obstacle mask must be on a CUDA device, got {obstacles.device}")
    if obstacles.dtype != torch.bool or not obstacles.is_contiguous():
        raise ValueError("obstacle mask must be a contiguous bool tensor")
    if tuple(obstacles.shape) != (params.ny, params.nx):
        raise ValueError(
            f"obstacle mask shape {tuple(obstacles.shape)} != ({params.ny}, {params.nx})"
        )


def check_state(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams,
                storage: str = "f32") -> None:
    """Validate a CUDA state for the kernels: (9, ny, nx), float32 (or int16
    for ``storage="i16"``), contiguous, on the mask's device."""
    if f.device != obstacles.device:
        raise ValueError(f"state on {f.device} but obstacle mask on {obstacles.device}")
    dtype = STATE_DTYPES[storage]
    if f.dtype != dtype or not f.is_contiguous():
        raise ValueError(f"state must be a contiguous {dtype} tensor")
    if tuple(f.shape) != (9, params.ny, params.nx):
        raise ValueError(f"state shape {tuple(f.shape)} != (9, {params.ny}, {params.nx})")


def is_plain(f: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel);
    raises for any other device."""
    if f.device.type == "cpu":
        return True
    if f.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {f.device}; use cuda or cpu")


def codec_arg(params: LBMParams, storage: str):
    """(i16 flag, host codec array or None) as the kernels take them; keep
    the array alive while the kernels may be launched."""
    if storage == "i16":
        return 1, quant.codec_constants(params.density)
    return 0, None


def codec_ptr(codec: np.ndarray | None) -> ctypes.c_void_p | None:
    return None if codec is None else codec.ctypes.data_as(ctypes.c_void_p)


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int,
                 storage: str = "f32"):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: ``num_steps`` K1
    launches ping-ponging between two buffers, allocated here once.

    ``f0`` is not modified.  On the card the returned state is one of the
    runner's two buffers and stays valid until the runner's next call."""
    quant.check_storage(storage)
    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return run_plain(f, obstacles, params, num_steps, storage)

        return run_all_plain

    check_mask(obstacles, params)
    lib = _build.load()
    dev = obstacles.device
    shape = (9, params.ny, params.nx)
    fa = torch.empty(shape, dtype=STATE_DTYPES[storage], device=dev)
    fb = torch.empty_like(fa)
    nblocks = lib.lbm_step_blocks(params.ny, params.nx)
    batch = max(1, min(TOT_BATCH, num_steps))
    partials = torch.empty((batch, nblocks), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)
    i16, codec = codec_arg(params, storage)

    def run_all(f):
        global LAUNCHES, LAUNCHES_I16
        if is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        check_state(f, obstacles, params, storage)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        if num_steps == 0:
            return f, tot
        fa.copy_(f)
        rc = lib.lbm_step_run(
            fa.data_ptr(), fb.data_ptr(), obstacles.data_ptr(), partials.data_ptr(),
            tot.data_ptr(), params.ny, params.nx, params.accel_row, omega, w1, w2,
            i16, codec_ptr(codec), num_steps, batch,
            torch.cuda.current_stream(dev).cuda_stream, dev.index,
        )
        _build.check(rc, "K1 step kernel")
        if i16:
            LAUNCHES_I16 += num_steps
        else:
            LAUNCHES += num_steps
        return (fb if num_steps % 2 else fa), tot

    return run_all


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


def _check_window(name: str, t: torch.Tensor, rows: int, nx: int, dtype, device) -> None:
    """A (9, rows, nx) window the slab kernels take: rows nx apart, unit
    column stride, any plane stride."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != (9, rows, nx):
        raise ValueError(f"{name} shape {tuple(t.shape)} != (9, {rows}, {nx})")
    if t.stride(2) != 1 or (rows > 1 and t.stride(1) != nx):
        raise ValueError(f"{name} must have unit column stride and row stride {nx}")


def bind_slab_step(params: LBMParams, body: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   obst_slab: torch.Tensor, out: torch.Tensor, tots: torch.Tensor,
                   row_offset: int, storage: str = "f32"):
    """Bind one K1-slab step to fixed buffers: returns ``launch(t)``, which
    advances ``body`` (9, n, nx) one step, with ghost rows ``lo`` / ``hi``
    (9, 1, nx) below / above it, into ``out`` (9, n, nx), and writes the
    slab's tot_u into ``tots[t]``.

    ``body``, ``lo``, ``hi`` and ``out`` may be windows of larger tensors
    (any plane stride, rows nx apart); ``obst_slab`` is the contiguous
    (n + 2, nx) bool mask with its ghost rows; ``row_offset`` the global row
    of body row 0.  Everything is checked here, once, so that the launch
    itself costs one call.  On CPU tensors ``launch`` runs the plain
    version; on CUDA tensors it launches the kernel or raises."""
    quant.check_storage(storage)
    n, nx = body.shape[1], body.shape[2]
    dev, dtype = body.device, STATE_DTYPES[storage]
    for name, t, rows in (("body", body, n), ("lo", lo, 1), ("hi", hi, 1), ("out", out, n)):
        _check_window(name, t, rows, nx, dtype, dev)
    if (obst_slab.device != dev or obst_slab.dtype != torch.bool
            or not obst_slab.is_contiguous() or tuple(obst_slab.shape) != (n + 2, nx)):
        raise ValueError(f"obstacle slab must be a contiguous ({n + 2}, {nx}) bool tensor on "
                         f"{dev}")
    if tots.device != dev or tots.dtype != torch.float32 or tots.dim() != 1:
        raise ValueError(f"tots must be a 1-D float32 tensor on {dev}")

    if is_plain(body):
        return bind_slab_plain(params, body, lo, hi, obst_slab, out, tots, row_offset, storage)

    lib = _build.load()
    partials = torch.empty(lib.lbm_step_blocks(n, nx), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)
    i16, codec = codec_arg(params, storage)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (body.data_ptr(), body.stride(0), lo.data_ptr(), lo.stride(0), hi.data_ptr(),
            hi.stride(0), obst_slab.data_ptr(), out.data_ptr(), out.stride(0),
            partials.data_ptr())
    tail = (n, nx, row_offset, params.accel_row, omega, w1, w2, i16, codec_ptr(codec),
            stream, dev.index)
    tot0, tot_n = tots.data_ptr(), tots.shape[0]

    def launch(t):
        global SLAB_LAUNCHES, SLAB_LAUNCHES_I16
        if not 0 <= t < tot_n:
            raise IndexError(f"step {t} outside tots of {tot_n}")
        rc = lib.lbm_slab_step(*args, tot0 + 4 * t, *tail)
        _build.check(rc, "K1-slab step kernel")
        if i16:
            SLAB_LAUNCHES_I16 += 1
        else:
            SLAB_LAUNCHES += 1

    launch.keep = (partials, codec)  # alive while the launcher is
    return launch


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
    if is_plain(f):
        return step_plain(f, obstacles, params, storage)
    f_new, tot = make_run_all(params, obstacles, 1, storage)(f)
    return fused_torch.StepOutput(f_new, tot[0])
