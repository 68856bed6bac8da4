"""What every kernel wrapper shares: the checks of what a kernel takes, the
codec's arguments, and the builders of the runners and launchers.

A wrapper's ``make_run_all`` builds ``f0 -> (f_final, tot_us)`` through
:func:`card_or_plain`, and its ``bind_*`` builds ``launch(t)`` through
:func:`launcher`: both take the plain version only for tensors on the CPU,
and for CUDA tensors launch the kernel or raise; they never fall back.  The
launches themselves go through ``_build.launch`` (a binder's through a
launcher ``_build.bind`` made), which counts them by the kernel's form.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, quant
from lbm_tpu_torch.params import LBMParams

STATE_DTYPES = {"f32": torch.float32, "i16": torch.int16}

# Steps whose per-block |u| partials are held before one reduce launch turns
# them into per-step sums (bounds the partials buffer at 256 x blocks floats;
# K1, K1-batch and the sweeps' batches of K-step launches).
TOT_BATCH = 256


def form(kernel: str, storage: str) -> str:
    """The kernel's form for a storage: ``kernel`` for float32 state, its
    ``-i16`` form for int16 (``"K3"`` -> ``"K3-i16"``)."""
    return f"{kernel}-i16" if storage == "i16" else kernel


def is_plain(f: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel);
    raises for any other device."""
    if f.device.type == "cpu":
        return True
    if f.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {f.device}; use cuda or cpu")


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


def check_window(name: str, t: torch.Tensor, rows: int, nx: int, dtype, device) -> None:
    """A (9, rows, nx) window the slab kernels take: rows nx apart, unit
    column stride, any plane stride."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != (9, rows, nx):
        raise ValueError(f"{name} shape {tuple(t.shape)} != (9, {rows}, {nx})")
    if t.stride(2) != 1 or (rows > 1 and t.stride(1) != nx):
        raise ValueError(f"{name} must have unit column stride and row stride {nx}")


def check_slab(what: str, obst: torch.Tensor, rows: int, nx: int, tots: torch.Tensor,
               device) -> None:
    """The obstacle slab and the sums of a bound launch: ``obst`` a
    contiguous (rows, nx) bool tensor and ``tots`` a 1-D float32 one, both
    on ``device``."""
    if (obst.device != device or obst.dtype != torch.bool or not obst.is_contiguous()
            or tuple(obst.shape) != (rows, nx)):
        raise ValueError(f"{what} must be a contiguous ({rows}, {nx}) bool tensor on {device}")
    if tots.device != device or tots.dtype != torch.float32 or tots.dim() != 1:
        raise ValueError(f"tots must be a 1-D float32 tensor on {device}")


def codec_arg(params: LBMParams, storage: str):
    """(i16 flag, host codec array or None) as the kernels take them; keep
    the array alive while the kernels may be launched."""
    if storage == "i16":
        return 1, quant.codec_constants(params.density)
    return 0, None


def codec_ptr(codec: np.ndarray | None) -> ctypes.c_void_p | None:
    return None if codec is None else codec.ctypes.data_as(ctypes.c_void_p)


def chunk_lengths(num_steps: int, chunk: int) -> list[int]:
    """The steps of each launch of a chunked run: full chunks of ``chunk``
    steps (at most ``num_steps``), then the remainder."""
    chunk = max(1, min(chunk, num_steps)) if num_steps else 1
    n_full, rem = divmod(num_steps, chunk)
    return [chunk] * n_full + ([rem] if rem else [])


def cooperative_grid(lib, entry: str, kernel: str, device: torch.device, *args) -> int:
    """The blocks of a cooperative launch of ``kernel`` on ``device``: the
    library's query ``entry(*args, device index)``, which must be
    positive."""
    grid = getattr(lib, entry)(*args, device.index)
    if grid <= 0:
        raise RuntimeError(
            f"{kernel} cannot be launched cooperatively on {torch.cuda.get_device_name(device)}")
    return grid


def card_or_plain(params: LBMParams, obstacles: torch.Tensor, plain: Callable,
                  card: Callable, storage: str = "f32", lib=None,
                  check: Callable | None = None):
    """A wrapper's runner ``f0 -> (f_final, tot_us)`` for ``obstacles``.

    On a CPU mask: ``plain(f0)``, the plain version, for a CPU state only.
    On a CUDA mask (:func:`check_mask`): ``card(lib)`` is called here, once,
    with the kernel library (``_build.load()`` by default) to allocate the
    kernel's buffers, and returns the kernel's runner; each call first
    refuses a CPU state, then checks the state with ``check(f0)``
    (:func:`check_state` of ``params`` and ``storage`` by default; a caller
    that passes its own checks its own mask)."""
    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return plain(f)

        return run_all_plain

    if check is None:
        check_mask(obstacles, params)

        def check(f):
            check_state(f, obstacles, params, storage)

    elif obstacles.device.type != "cuda":
        raise ValueError(f"no kernel for device {obstacles.device}; use cuda or cpu")
    run = card(lib or _build.load())

    def run_all(f):
        if is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        check(f)
        return run(f)

    return run_all


def launcher(body: torch.Tensor, plain: Callable, card: Callable, lib=None):
    """A wrapper's bound ``launch(t)`` for tensors on ``body``'s device, its
    arguments checked by the caller: ``plain``, the plain version's
    launcher, on the CPU; on a CUDA device ``card(lib)``, which allocates
    the kernel's buffers with the kernel library (``_build.load()`` by
    default) and returns the kernel's launcher."""
    if is_plain(body):
        return plain
    return card(lib or _build.load())
