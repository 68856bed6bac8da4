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
   maps one: K4 (``cuda-trapezoid``; the default), K5 (``cuda-skew``;
   forced only) or K9 (``cuda-hbm``, the HBM-parts sweep; forced only, f32),
   the remainder steps on K1;
4. else a loop of K1 launches (``cuda-step``; int16 from 512^2 up).  A
   forced depth that cannot map warns and lands here.

So by default f32 runs K2 to 768^2, K3 at 1024^2 and K4 (K = 4) above:
the fastest kernel of each grid in the H100 table (PERF.md §5), except
1024^2, where K4 timed faster than K3 but ``lbm_tpu``'s order keeps the
in-place kernel.  int16 runs K3-i16 to 256^2 and K1-i16 above; K4-i16,
though faster, strays further from f32 (``temporal_cuda.pick_k``) and runs
only with ``--temporal-k``.

``LBM_RESIDENT_KIND`` forces the resident kernel (:func:`resident_kind_choice`):
``mono`` K2, ``inplace`` K3, ``blocked`` K10 (``cuda-blocked``, the port of
B4), ``auto`` the policy above, which never picks K10.

``step`` is K1 (K1-i16).  ``storage="i16"`` needs the cuda backend.  The
``torch`` backend runs the plain twin on either device, f32 only, and takes
no ``temporal_k``, as ``lbm_tpu``'s jnp backend does not.  On the CPU the
``cuda`` backend's wrappers run their plain versions.

``u_mag`` is the frame of a state, |u| per cell and 0 on obstacles,
``lbm_tpu``'s ``_u_mag_fn`` (modes.py:177-185) op for op.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import (
    blocked_cuda,
    fused_cuda,
    fused_torch,
    hbm_cuda,
    inplace_cuda,
    quant,
    resident_cuda,
    skew_cuda,
    temporal_cuda,
)
from lbm_tpu_torch.params import LBMParams


@dataclasses.dataclass
class StepProgram:
    """A runnable step program: single-device, or row-sharded
    (parallel/modes.py, whose state is a ``ShardedState``)."""

    init_state: Any  # (9, ny, nx) float32 or int16 on ``device``, or a ShardedState
    step: Callable[[Any], tuple[Any, torch.Tensor]]  # state -> (state, tot_u)
    # num_steps -> runner ``state -> (state, tot_us (num_steps,))``; buffers
    # are allocated when the runner is built, never per step.
    make_run_all: Callable[[int], Callable]
    f_of: Callable[[Any], torch.Tensor]  # state -> (9, ny, nx) float32 distributions
    tot_cells: int  # fluid cells, the divisor of av_vels
    variant: str
    # Steps per temporal sweep of make_run_all (1: no sweeps).  A run of
    # sweep_k + 1 steps launches each of its kernels (the driver's warm-up),
    # and segments of whole sweeps quantize int16 where an unsegmented run does.
    sweep_k: int = 1
    # Steps per step() call and the unit of make_run_all: k for the chunked
    # mode (step then returns a (k,) tot_u vector), else 1.
    steps_per_call: int = 1
    # Chunked only: the chunk decomposed into one frozen-ghost step
    # (state -> (state, tot_u)) and one ghost exchange (state -> state);
    # step() == k x inner + exchange.  The driver runs a remainder of
    # steps as exchange-then-inner per step.
    chunk_inner_step: Callable[[Any], tuple[Any, torch.Tensor]] | None = None
    chunk_exchange: Callable[[Any], Any] | None = None
    # ca only: the K-sweep engine that runs it (``slab``, ``resident`` or
    # ``inplace``; parallel/modes.py ca_engine_choice).
    engine: str | None = None
    # state -> (ny, nx) float32 |u|, 0 on obstacles: the frame of a state,
    # on the device of f_of's result.
    u_mag: Callable[[Any], torch.Tensor] | None = None
    # (rows, columns) of the state inside the program, seam padding
    # included; a buffer of frames has this shape per frame, and frames are
    # cropped to the grid at collate (lbm_tpu's modes.py:110-114).
    global_shape: tuple[int, int] | None = None


def u_mag_fn(obstacles: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``f (9, ny, nx) -> (ny, nx)`` |u| of each cell from its moments, 0 on
    obstacles (``lbm_tpu``'s ``_u_mag_fn``, modes.py:177-185, op for op)."""

    def u_mag(f: torch.Tensor) -> torch.Tensor:
        rho = torch.sum(f, dim=0)
        u_x = ((f[1] + f[5] + f[8]) - (f[3] + f[6] + f[7])) / rho
        u_y = ((f[2] + f[5] + f[6]) - (f[4] + f[7] + f[8])) / rho
        speed = torch.sqrt(u_x * u_x + u_y * u_y)
        return torch.where(obstacles, torch.zeros_like(speed), speed)

    return u_mag


RESIDENT_KINDS = ("mono", "inplace", "blocked")


def resident_kind_choice(params: LBMParams, storage: str = "f32") -> str | None:
    """The variant ``LBM_RESIDENT_KIND`` forces on the cuda backend, or None
    for ``auto`` (unset): ``mono`` -> K2 (``cuda-resident``), ``inplace`` ->
    K3 (``cuda-inplace[-i16]``), ``blocked`` -> K10 (``cuda-blocked``), whatever
    ``temporal_k`` is, as ``lbm_tpu``'s resident branch (modes.py:493-505).

    ``lbm_tpu``'s knob (resident_pallas.auto_raised_plan :141-154) picks the
    kernel of its raised scoped-VMEM band, and its only route to B4 is a
    raised ``LBM_VMEM_LIMIT_MB`` beyond the monolithic budget; the VMEM
    ladder is not ported, so ``blocked`` is the port's route to B4.  Auto
    never picks K10, as ``lbm_tpu``'s auto never reaches B4 where the
    in-place band fits (:82-84).

    A forced kind that cannot map raises ``ValueError``: K2 beyond
    ``resident_cuda.L2_STATE_BUDGET`` or with int16, K3 beyond its budget of
    the storage, K10 with int16 (K10 takes any f32 grid: its copies stream
    from HBM where they do not fit L2)."""
    kind = os.environ.get("LBM_RESIDENT_KIND", "auto").strip().lower()
    if kind == "auto":
        return None
    if kind not in RESIDENT_KINDS:
        raise ValueError(f"LBM_RESIDENT_KIND={kind!r}; use one of {RESIDENT_KINDS} or auto")
    grid = f"the {params.nx}x{params.ny} grid"
    if kind == "inplace":
        if not inplace_cuda.fits_l2(params.ny, params.nx, storage):
            raise ValueError(f"LBM_RESIDENT_KIND=inplace: K3 (one {storage} copy within its L2 "
                             f"budget) cannot map {grid}")
        return "cuda-inplace" + ("-i16" if storage == "i16" else "")
    if storage != "f32":
        raise ValueError(f"LBM_RESIDENT_KIND={kind}: storage {storage!r} maps only the "
                         "in-place resident kernel (LBM_RESIDENT_KIND=inplace)")
    if kind == "mono":
        if not resident_cuda.fits_l2(params.ny, params.nx):
            raise ValueError(f"LBM_RESIDENT_KIND=mono: K2 (two f32 copies within "
                             f"{resident_cuda.L2_STATE_BUDGET >> 20} MiB) cannot map {grid}")
        return "cuda-resident"
    return "cuda-blocked"


def temporal_impl_choice(params: LBMParams, K: int, storage: str = "f32") -> str | None:
    """Which sweep kernel runs a K-deep sweep of this grid: ``'skew'`` (K5,
    ops/skew_cuda.py), ``'trapezoid'`` (K4, ops/temporal_cuda.py),
    ``'hbm'`` (K9, ops/hbm_cuda.py), or None when none maps
    (``lbm_tpu.parallel.modes.temporal_impl_choice``; the lane-padding
    argument has no counterpart, the kernels take any nx).

    ``LBM_TEMPORAL_IMPL`` forces one (``skew`` / ``trapezoid``; None where
    it cannot map).  ``hbm`` (``modes.py`` :229-230) runs K9 and never
    falls through to another kernel: where K9 cannot map (int16 state, or
    no part size, ``hbm_cuda.plan``) it raises ``ValueError``.  Auto never
    picks it, as in ``lbm_tpu``.  Auto: K4 where it maps, else None (the K1
    loop), from the H100 table
    (PERF.md §5, ``tools/kernel_times.py --sweeps``): K5 was slower than K1
    at every grid (512^2-4096^2) and depth (2, 4, 8) timed, f32 and int16,
    so it runs only when forced.  ``lbm_tpu`` prefers the skewed pair, which
    won on the TPU."""
    impl = os.environ.get("LBM_TEMPORAL_IMPL", "auto").strip().lower()
    if impl not in ("auto", "skew", "trapezoid", "hbm"):
        raise ValueError(f"LBM_TEMPORAL_IMPL={impl!r}; use skew, trapezoid, hbm or auto")
    if impl == "hbm":
        if not hbm_cuda.supports(params, K, storage):
            raise ValueError(f"LBM_TEMPORAL_IMPL=hbm: the HBM-parts sweep (K={K}, {storage}) "
                             f"cannot map the {params.nx}x{params.ny} grid")
        return "hbm"
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
    map warns with ``lbm_tpu``'s text and gives the K1 loop.

    Variants: ``cuda-resident`` (K2), ``cuda-inplace[-i16]`` (K3),
    ``cuda-blocked`` (K10, forced only: :func:`resident_kind_choice`),
    ``cuda-trapezoid[-i16]`` (K4), ``cuda-skew[-i16]`` (K5), ``cuda-hbm``
    (K9), ``cuda-step[-i16]`` (K1)."""
    suffix = "-i16" if storage == "i16" else ""
    forced = resident_kind_choice(params, storage)
    if forced is not None:
        return forced, 1
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
            "cuda-blocked": lambda n: blocked_cuda.make_run_all(params, obst, n),
            "cuda-inplace": lambda n: inplace_cuda.make_run_all(params, obst, n, storage=storage),
            "cuda-trapezoid": lambda n: temporal_cuda.make_run_all(params, obst, n, K, storage),
            "cuda-skew": lambda n: skew_cuda.make_run_all(params, obst, n, K, storage),
            "cuda-hbm": lambda n: hbm_cuda.make_run_all(params, obst, n, K, storage),
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

    mag = u_mag_fn(obst)
    return StepProgram(
        init_state=init_state,
        step=step,
        make_run_all=make_run_all,
        f_of=f_of,
        tot_cells=tot_cells,
        variant=variant,
        sweep_k=K,
        u_mag=lambda state: mag(f_of(state)),
        global_shape=(ny, nx),
    )
