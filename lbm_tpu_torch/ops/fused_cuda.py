"""K1: the one-step CUDA kernel (csrc/step.cu) and its wrappers.

Replaces ``lbm_tpu/ops/fused_pallas.py::_step_kernel`` (:249, entry
``make_step`` :522) in its f32 full-grid periodic form.  One launch advances
the whole grid one step and leaves a |u| partial per block; a second, small
launch per batch of steps reduces the partials into per-step sums in a fixed
order.

Bound: device-memory bytes, 9 x 4 B read + 9 x 4 B written per cell-step.
The kernel reads every plane's pulled row segments coalesced and wraps both
axes by index arithmetic, so a step is one pass over the state with no ghost
assembly (see the note at the top of csrc/step.cu).

Beside the kernel:

- the plain version, :func:`step_plain` / :func:`run_plain`: the torch twin
  (ops/fused_torch.py), which the kernel matches bitwise on fields;
- ``LAUNCHES``: the number of step-kernel launches so far, raised only where
  the kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_torch
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0

# Steps whose per-block |u| partials are held before one reduce launch turns
# them into per-step sums (bounds the partials buffer at 256 x blocks floats).
TOT_BATCH = 256


def step_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams):
    """The plain version of one K1 launch: the twin step."""
    return fused_torch.fused_step_single(f, obstacles, params)


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int):
    """The plain version of a K1 loop: ``num_steps`` twin steps."""
    return fused_torch.run_steps(f, obstacles, params, num_steps)


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


def check_state(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams) -> None:
    """Validate a CUDA state for the kernels: (9, ny, nx) float32, contiguous,
    on the mask's device."""
    if f.device != obstacles.device:
        raise ValueError(f"state on {f.device} but obstacle mask on {obstacles.device}")
    if f.dtype != torch.float32 or not f.is_contiguous():
        raise ValueError("state must be a contiguous float32 tensor")
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


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: ``num_steps`` K1
    launches ping-ponging between two buffers, allocated here once.

    ``f0`` is not modified.  On the card the returned state is one of the
    runner's two buffers and stays valid until the runner's next call."""
    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return run_plain(f, obstacles, params, num_steps)

        return run_all_plain

    check_mask(obstacles, params)
    lib = _build.load()
    dev = obstacles.device
    shape = (9, params.ny, params.nx)
    fa = torch.empty(shape, dtype=torch.float32, device=dev)
    fb = torch.empty(shape, dtype=torch.float32, device=dev)
    nblocks = lib.lbm_step_blocks(params.ny, params.nx)
    batch = max(1, min(TOT_BATCH, num_steps))
    partials = torch.empty((batch, nblocks), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)

    def run_all(f):
        global LAUNCHES
        if is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        check_state(f, obstacles, params)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        if num_steps == 0:
            return f, tot
        fa.copy_(f)
        rc = lib.lbm_step_run(
            fa.data_ptr(), fb.data_ptr(), obstacles.data_ptr(), partials.data_ptr(),
            tot.data_ptr(), params.ny, params.nx, params.accel_row, omega, w1, w2,
            num_steps, batch, torch.cuda.current_stream(dev).cuda_stream, dev.index,
        )
        _build.check(rc, "K1 step kernel")
        LAUNCHES += num_steps
        return (fb if num_steps % 2 else fa), tot

    return run_all


def step(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams) -> fused_torch.StepOutput:
    """One step: ``f -> (f_new, tot_u)``.  K1 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if is_plain(f):
        return step_plain(f, obstacles, params)
    f_new, tot = make_run_all(params, obstacles, 1)(f)
    return fused_torch.StepOutput(f_new, tot[0])
