"""The single-device step program and the policy that picks its kernels.

The counterpart of ``lbm_tpu/parallel/modes.py``: ``StepProgram`` (:82) and
the f32 branch of ``build_single_program`` (:421).  A program holds the
initial state on its device, the one-step function, and ``make_run_all``,
which builds the runner the driver calls once per segment.

Policy for the ``cuda`` backend on a CUDA device:

- ``step`` is K1 (ops/fused_cuda.py);
- ``make_run_all`` is K2 (ops/resident_cuda.py) where two f32 copies of
  the state fit ``resident_cuda.L2_STATE_BUDGET``, else a loop of K1
  launches (1024^2 ping-pong is 72 MiB).

The ``torch`` backend runs the plain twin on either device.  On the CPU the
``cuda`` backend's wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import fused_cuda, fused_torch, resident_cuda
from lbm_tpu_torch.params import LBMParams


@dataclasses.dataclass
class StepProgram:
    """A runnable single-device step program."""

    init_state: torch.Tensor  # (9, ny, nx) float32 on ``device``
    step: Callable[[torch.Tensor], fused_torch.StepOutput]  # f -> (f, tot_u)
    # num_steps -> runner ``f0 -> (f, tot_us (num_steps,))``; buffers are
    # allocated when the runner is built, never per step.
    make_run_all: Callable[[int], Callable]
    tot_cells: int  # fluid cells, the divisor of av_vels
    variant: str


def build_single_program(
    params: LBMParams,
    obstacles: np.ndarray,
    device: torch.device,
    backend: str = "torch",
    f0: torch.Tensor | np.ndarray | None = None,
) -> StepProgram:
    """Single-device program (periodic full grid, f32 state)."""
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}; use 'torch' or 'cuda'")
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
            return fused_cuda.step(f, obst, params)

        if resident_cuda.fits_l2(ny, nx):
            variant = "cuda-resident"

            def make_run_all(num_steps):
                return resident_cuda.make_run_all(params, obst, num_steps)

        else:
            variant = "cuda-step"

            def make_run_all(num_steps):
                return fused_cuda.make_run_all(params, obst, num_steps)

    else:
        variant = "torch"

        def step(f):
            return fused_torch.fused_step_single(f, obst, params)

        def make_run_all(num_steps):
            return lambda f: fused_torch.run_steps(f, obst, params, num_steps)

    return StepProgram(
        init_state=f0,
        step=step,
        make_run_all=make_run_all,
        tot_cells=tot_cells,
        variant=variant,
    )
