"""The single-device step program and the policy that picks its kernels.

The counterpart of ``lbm_tpu/parallel/modes.py``: ``StepProgram`` (:82),
``build_single_program`` (:421), ``_i16_single_program`` (:662),
``temporal_impl_choice`` (:188) and ``_temporal_run_all`` (:365, in
:func:`cuda_choice`).  A program holds the initial state on its device,
the one-step function, ``make_run_all``, which builds the runner the driver
calls once per segment, and ``f_of``, which turns a state into float32
distributions (dequantizes int16 storage).

Policy for the ``cuda`` backend, in ``lbm_tpu``'s order (modes.py:493-543;
variant names in brackets, ``-i16`` appended for int16 storage):

1. K2 (``cuda-resident``, f32 only) where two f32 copies of the state fit
   ``resident_cuda.L2_STATE_BUDGET`` (to 768^2), whatever ``temporal_k``
   is;
2. K3 (``cuda-inplace``) where one copy fits
   ``inplace_cuda.L2_INPLACE_BUDGET`` (f32: the 1024^2 headline, 36 MiB)
   or ``L2_INPLACE_BUDGET_I16`` (int16: 2 MiB, to 256^2), only when
   ``temporal_k`` is None: an explicit ``--temporal-k`` opts back into the
   sweeps;
3. the temporal sweeps, K steps per pass over device memory, where the
   depth (``temporal_k``, else ``temporal_cuda.pick_k``: 4 from 1024^2
   cells in f32, 1 in int16) is at least 2 and :func:`temporal_impl_choice`
   maps one: K4 (``cuda-trapezoid``; the default) or K5 (``cuda-skew``;
   forced only), the remainder steps on K1;
4. else a loop of K1 launches (``cuda-step``; int16 from 512^2 up).  A
   forced depth that cannot map warns and lands here.

So by default f32 runs K2 to 768^2, K3 at 1024^2 and K4 (K = 4) above:
the fastest kernel of each grid in the H100 table (PERF.md §5), except
1024^2, where K4 timed faster than K3 but ``lbm_tpu``'s order keeps the
in-place kernel.  int16 runs K3-i16 to 256^2 and K1-i16 above; K4-i16,
though faster, strays further from f32 (``temporal_cuda.pick_k``) and runs
only with ``--temporal-k``.

``step`` is K1 (K1-i16).  ``storage="i16"`` needs the cuda backend.  The
``torch`` backend runs the plain twin on either device, f32 only, and takes
no ``temporal_k``, as ``lbm_tpu``'s jnp backend does not.  On the CPU the
``cuda`` backend's wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.models.variants import NotPortedError
from lbm_tpu_torch.ops import (
    fused_cuda,
    fused_torch,
    inplace_cuda,
    quant,
    resident_cuda,
    skew_cuda,
    temporal_cuda,
)
from lbm_tpu_torch.params import LBMParams


@dataclasses.dataclass
class StepProgram:
    """A runnable single-device step program."""

    init_state: torch.Tensor  # (9, ny, nx) float32 or int16 on ``device``
    step: Callable[[torch.Tensor], fused_torch.StepOutput]  # f -> (f, tot_u)
    # num_steps -> runner ``f0 -> (f, tot_us (num_steps,))``; buffers are
    # allocated when the runner is built, never per step.
    make_run_all: Callable[[int], Callable]
    f_of: Callable[[torch.Tensor], torch.Tensor]  # state -> float32 distributions
    tot_cells: int  # fluid cells, the divisor of av_vels
    variant: str
    # Steps per temporal sweep of make_run_all (1: no sweeps).  A run of
    # sweep_k + 1 steps launches each of its kernels (the driver's warm-up),
    # and segments of whole sweeps quantize int16 where an unsegmented run does.
    sweep_k: int = 1


def temporal_impl_choice(params: LBMParams, K: int, storage: str = "f32") -> str | None:
    """Which sweep kernel runs a K-deep sweep of this grid: ``'skew'`` (K5,
    ops/skew_cuda.py), ``'trapezoid'`` (K4, ops/temporal_cuda.py), or None
    when neither maps (``lbm_tpu.parallel.modes.temporal_impl_choice``; the
    lane-padding argument has no counterpart, the kernels take any nx).

    ``LBM_TEMPORAL_IMPL`` forces one (``skew`` / ``trapezoid``; None where
    it cannot map).  ``hbm`` (B7) is not ported and raises
    :class:`NotPortedError`: it never falls through to another kernel.
    Auto: K4 where it maps, else None (the K1 loop), from the H100 table
    (PERF.md §5, ``tools/kernel_times.py --sweeps``): K5 was slower than K1
    at every grid (512^2-4096^2) and depth (2, 4, 8) timed, f32 and int16,
    so it runs only when forced.  ``lbm_tpu`` prefers the skewed pair, which
    won on the TPU."""
    impl = os.environ.get("LBM_TEMPORAL_IMPL", "auto").strip().lower()
    if impl == "hbm":
        raise NotPortedError("LBM_TEMPORAL_IMPL=hbm (the HBM-pipelined sweep) is")
    if impl not in ("auto", "skew", "trapezoid"):
        raise ValueError(f"LBM_TEMPORAL_IMPL={impl!r}; use skew, trapezoid or auto")
    if impl == "skew":
        return "skew" if skew_cuda.supports(params, K, storage) else None
    return "trapezoid" if temporal_cuda.supports(params, K, storage) else None


def cuda_choice(params: LBMParams, storage: str = "f32",
                temporal_k: int | None = None) -> tuple[str, int]:
    """(variant, K) of the cuda backend for this grid: the policy at the top
    of this module, with ``lbm_tpu``'s dispatch (modes.py:493-543) and its
    ``_temporal_run_all`` (:365).  K is the sweep depth (1 off the sweeps).

    ``temporal_k``: None picks the depth (``temporal_cuda.pick_k``), 1
    disables the sweeps, >= 2 forces a depth; a forced depth that cannot
    map warns with ``lbm_tpu``'s text and gives the K1 loop."""
    suffix = "-i16" if storage == "i16" else ""
    if storage == "f32" and resident_cuda.fits_l2(params.ny, params.nx):
        return "cuda-resident", 1
    if temporal_k is None and inplace_cuda.fits_l2(params.ny, params.nx, storage):
        return "cuda-inplace" + suffix, 1
    K = temporal_k if temporal_k is not None else temporal_cuda.pick_k(params, storage)
    impl = temporal_impl_choice(params, K, storage) if K >= 2 else None
    if impl is not None:
        return f"cuda-{impl}{suffix}", K
    if temporal_k is not None and temporal_k >= 2:
        warnings.warn(
            f"--temporal-k {temporal_k} was requested but the "
            f"{params.nx}x{params.ny} grid cannot map the temporal "
            "sweep at that depth; falling back to the single-step "
            "kernel",
            stacklevel=3,
        )
    return "cuda-step" + suffix, 1


def build_single_program(
    params: LBMParams,
    obstacles: np.ndarray,
    device: torch.device,
    backend: str = "torch",
    f0: torch.Tensor | np.ndarray | None = None,
    storage: str = "f32",
    temporal_k: int | None = None,
) -> StepProgram:
    """Single-device program (periodic full grid, f32 or i16 state).
    ``temporal_k`` as in ``lbm_tpu``: None = auto, 1 = no temporal sweeps,
    >= 2 = a forced depth (the cuda backend only)."""
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}; use 'torch' or 'cuda'")
    quant.check_storage(storage)
    if storage == "i16" and backend != "cuda":
        raise ValueError("storage 'i16' requires the cuda backend")
    ny, nx = params.ny, params.nx
    if obstacles.shape != (ny, nx):
        raise ValueError(f"obstacle mask {obstacles.shape} does not match grid ({ny}, {nx})")
    obst = torch.from_numpy(np.ascontiguousarray(obstacles, dtype=bool)).to(device)
    if f0 is None:
        f0 = lattice.equilibrium_rest_device(params.density, ny, nx, device)
    else:
        f0 = torch.as_tensor(f0, dtype=torch.float32).to(device).contiguous()
        if tuple(f0.shape) != (9, ny, nx):
            raise ValueError(f"initial state {tuple(f0.shape)} does not match (9, {ny}, {nx})")
    tot_cells = int(obstacles.size - np.count_nonzero(obstacles))

    K = 1
    if backend == "cuda":

        def step(f):
            return fused_cuda.step(f, obst, params, storage)

        variant, K = cuda_choice(params, storage, temporal_k)
        make_run_all = {
            "cuda-resident": lambda n: resident_cuda.make_run_all(params, obst, n),
            "cuda-inplace": lambda n: inplace_cuda.make_run_all(params, obst, n, storage=storage),
            "cuda-trapezoid": lambda n: temporal_cuda.make_run_all(params, obst, n, K, storage),
            "cuda-skew": lambda n: skew_cuda.make_run_all(params, obst, n, K, storage),
            "cuda-step": lambda n: fused_cuda.make_run_all(params, obst, n, storage),
        }[variant.removesuffix("-i16")]

    else:
        variant = "torch"

        def step(f):
            return fused_torch.fused_step_single(f, obst, params)

        def make_run_all(num_steps):
            return lambda f: fused_torch.run_steps(f, obst, params, num_steps)

    if storage == "i16":
        init_state = quant.quantize(f0, params.density)

        def f_of(q):
            return quant.dequantize(q, params.density)

    else:
        init_state = f0

        def f_of(f):
            return f

    return StepProgram(
        init_state=init_state,
        step=step,
        make_run_all=make_run_all,
        f_of=f_of,
        tot_cells=tot_cells,
        variant=variant,
        sweep_k=K,
    )
