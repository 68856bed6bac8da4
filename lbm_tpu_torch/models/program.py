"""The single-device step program and the policy that picks its kernels.

The counterpart of ``lbm_tpu/parallel/modes.py``: ``StepProgram`` (:82),
``build_single_program`` (:421) and ``_i16_single_program`` (:662).  A
program holds the initial state on its device, the one-step function,
``make_run_all``, which builds the runner the driver calls once per
segment, and ``f_of``, which turns a state into float32 distributions
(dequantizes int16 storage).

Policy for the ``cuda`` backend (variant names in brackets):

- f32: ``step`` is K1; ``make_run_all`` is K2 (``cuda-resident``) where two
  f32 copies of the state fit ``resident_cuda.L2_STATE_BUDGET``, K3
  (``cuda-inplace``) where one copy fits ``inplace_cuda.L2_INPLACE_BUDGET``
  (the 1024^2 headline: 36 MiB), else a loop of K1 launches
  (``cuda-step``);
- i16 (``storage="i16"``, which needs the cuda backend): ``step`` is
  K1-i16; ``make_run_all`` is K3-i16 (``cuda-inplace-i16``) where one int16
  copy fits the same budget (square grids up to 1448^2: 1024^2 is 18 MiB),
  else a loop of K1-i16 launches (``cuda-step-i16``; 1536^2 is 40.5 MiB).

The ``torch`` backend runs the plain twin on either device, f32 only.  On
the CPU the ``cuda`` backend's wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import fused_cuda, fused_torch, inplace_cuda, quant, resident_cuda
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


def build_single_program(
    params: LBMParams,
    obstacles: np.ndarray,
    device: torch.device,
    backend: str = "torch",
    f0: torch.Tensor | np.ndarray | None = None,
    storage: str = "f32",
) -> StepProgram:
    """Single-device program (periodic full grid, f32 or i16 state)."""
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

    if backend == "cuda":

        def step(f):
            return fused_cuda.step(f, obst, params, storage)

        suffix = "-i16" if storage == "i16" else ""
        if storage == "f32" and resident_cuda.fits_l2(ny, nx):
            variant = "cuda-resident"

            def make_run_all(num_steps):
                return resident_cuda.make_run_all(params, obst, num_steps)

        elif inplace_cuda.fits_l2(ny, nx, storage):
            variant = "cuda-inplace" + suffix

            def make_run_all(num_steps):
                return inplace_cuda.make_run_all(params, obst, num_steps, storage=storage)

        else:
            variant = "cuda-step" + suffix

            def make_run_all(num_steps):
                return fused_cuda.make_run_all(params, obst, num_steps, storage)

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
    )
