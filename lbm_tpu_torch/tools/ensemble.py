"""Ensemble runs: B parameter variants of one scene at once.

The counterpart of ``lbm_tpu/tools/ensemble.py``.  The reference's
parameter studies (relaxation/acceleration sensitivity, README.md:104-123)
run the binary once per setting; ``lbm_tpu`` runs the B settings as one
compiled program (``jax.vmap`` over a leading instance axis).  Here the B
instances run on the card in one launch per step (K1-batch) or per
256-step chunk (K11 or K2-batch), ops/ensemble_cuda.py, and on the CPU through the
plain batched twin step (``fused_torch.ensemble_step``); every instance's
av_vels series and final state come back to the host at the end, into host
arrays prepared while the card runs (utils/hostcopy.py).

omega and the accel weights are per-instance float32 values, so instance b
reproduces a single run with b's parameters bitwise (tested).  The obstacle
mask is either shared (parameter sweep) or a (B, ny, nx) batch (geometry
sweep, the reference's obstacle-file studies); the grid shape is common to
all instances either way.  float32 only, as ``lbm_tpu``'s.

``run_ensemble`` times the driver's phases (``EnsembleResult.timer``), and
under a torch profiler they are ranges inside ``lbm.run_ensemble``
(utils/timing.py).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.models.driver import resolve_device
from lbm_tpu_torch.ops import ensemble_cuda
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.utils import hostcopy
from lbm_tpu_torch.utils.invariants import calc_reynolds
from lbm_tpu_torch.utils.timing import PhaseTimer, span


@dataclasses.dataclass
class EnsembleResult:
    omegas: np.ndarray  # (B,)
    accels: np.ndarray  # (B,)
    av_vels: np.ndarray  # (num_steps, B)
    f: np.ndarray  # (B, 9, ny, nx) final distributions
    reynolds: np.ndarray  # (B,)
    kernel: str = "plain"  # what ran: K11, K2-batch, K1-batch, or plain on the CPU
    plan: str = ""  # K11's plan ("C=8, 512 threads, 3 waves"); empty for the others
    # init (validation, the masks' upload, the rest state, the plan), compute
    # (the run, ended by a synchronize on a card), collate (the copies to the
    # host, av_vels, the Reynolds numbers)
    timer: PhaseTimer = dataclasses.field(default_factory=PhaseTimer)


def prepare(params: LBMParams, obstacles: np.ndarray, omegas, accels=None):
    """``lbm_tpu``'s validation and broadcasting (tools/ensemble.py:74-103):
    (obstacles bool, omegas (B,) float32, accels (B,) float32, fluid counts
    (B,) float32)."""
    obstacles = np.asarray(obstacles, dtype=bool)
    omegas = np.atleast_1d(np.asarray(omegas, dtype=np.float32))
    if omegas.ndim != 1 or omegas.size == 0:
        raise ValueError("omegas must be a non-empty 1-D sequence")
    if obstacles.ndim == 3 and omegas.size == 1:
        omegas = np.repeat(omegas, obstacles.shape[0])
    B = omegas.size
    accels = (
        np.full(B, params.accel, dtype=np.float32)
        if accels is None
        else np.asarray(accels, dtype=np.float32)
    )
    if accels.shape != (B,):
        raise ValueError(f"accels must have shape ({B},), got {accels.shape}")
    if obstacles.ndim == 3 and obstacles.shape[0] != B:
        raise ValueError(
            f"obstacle batch of {obstacles.shape[0]} masks does not match "
            f"{B} parameter instances"
        )
    # Per-instance fluid-cell counts (masks may differ in a geometry sweep).
    fluid_counts = np.asarray((~obstacles).sum(axis=(-2, -1)), dtype=np.float32)
    fluid_counts = np.broadcast_to(fluid_counts, (B,)).astype(np.float32)
    return obstacles, omegas, accels, fluid_counts


def make_runner(params: LBMParams, obstacles: np.ndarray, omegas, accels, num_steps: int,
                device, kernel: str | None = None):
    """(runner, f0_b) on ``device``: ``ensemble_cuda.make_run_all`` on the
    instances' masks and rest states (``runner.kernel`` names what runs)."""
    dev = resolve_device(device)
    B = omegas.size
    obst = torch.from_numpy(np.ascontiguousarray(obstacles)).to(dev)
    f0 = lattice.equilibrium_rest_device(params.density, params.ny, params.nx, dev)
    f0_b = f0.unsqueeze(0).expand(B, -1, -1, -1).contiguous()
    return ensemble_cuda.make_run_all(params, obst, omegas, accels, num_steps, kernel), f0_b


@span("run_ensemble")
def run_ensemble(
    params: LBMParams,
    obstacles: np.ndarray,
    omegas,
    accels=None,
    num_steps: int | None = None,
    device: str = "cuda",
) -> EnsembleResult:
    """Run B simultaneous variants of one scene (``lbm_tpu``'s
    ``run_ensemble``, on ``device``: cuda by default, which raises where
    there is none).

    Args:
      params: base scene parameters (grid, density, default accel/omega).
      obstacles: (ny, nx) bool mask shared by every instance, OR a
        (B, ny, nx) batch of masks for a GEOMETRY sweep.
      omegas: (B,) relaxation parameters, one per instance (or a single
        value broadcast over a geometry batch).
      accels: optional (B,) accelerations (default: params.accel for all).
    """
    timer = PhaseTimer()
    with timer.section("init"):
        obstacles, omegas, accels, fluid_counts = prepare(params, obstacles, omegas, accels)
        steps = num_steps if num_steps is not None else params.max_iters
        B = omegas.size
        run_all, f0_b = make_runner(params, obstacles, omegas, accels, steps, device)
    with timer.section("compute"):
        f_final, tots = run_all(f0_b)
        # The outputs' host arrays, faulted in while the card runs the study.
        host_f = hostcopy.prepare(f_final.shape, f_final.dtype, f_final.device)
        host_tots = hostcopy.prepare(tots.shape, tots.dtype, tots.device)
        if f_final.device.type == "cuda":
            torch.cuda.synchronize(f_final.device)
    with timer.section("collate"):
        av = hostcopy.fetch(tots, host_tots).astype(np.float32) / fluid_counts[None, :]
        final_av = av[-1] if steps else np.zeros(B, dtype=np.float32)
        reyn = np.asarray(
            [
                calc_reynolds(params.replace(omega=float(o)), float(a))
                for o, a in zip(omegas, final_av)
            ],
            dtype=np.float32,
        )
        f = hostcopy.fetch(f_final, host_f)
    return EnsembleResult(
        omegas=omegas,
        accels=accels,
        av_vels=av,
        f=f,
        reynolds=reyn,
        kernel=run_all.kernel,
        plan=run_all.plan.label() if run_all.plan else "",
        timer=timer,
    )


def ensemble_mlups(params: LBMParams, obstacles: np.ndarray, omegas, accels=None,
                   num_steps: int = 4000, repeats: int = 2, device: str = "cuda",
                   kernel: str | None = None) -> tuple[float, str]:
    """(best MLUPS of ``repeats`` timed runs, the kernel that ran): B
    instances x cells x steps over the host-clock seconds of a run that ends
    in ``torch.cuda.synchronize()``, after one untimed run (the build and
    the first launch are set-up, as ``bench`` bills them)."""
    obstacles, omegas, accels, _ = prepare(params, obstacles, omegas, accels)
    run_all, f0_b = make_runner(params, obstacles, omegas, accels, num_steps, device, kernel)
    dev = f0_b.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run_all(f0_b)
    sync()
    best = 0.0
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        run_all(f0_b)
        sync()
        seconds = time.perf_counter() - t0
        best = max(best, omegas.size * params.nx * params.ny * num_steps / seconds / 1e6)
    return best, run_all.kernel


def parse_range(spec: str, count: int | None = None) -> np.ndarray:
    """Parse ``a:b:n`` (linspace), ``a,b,c`` (list), or ``a`` (scalar)."""
    if ":" in spec:
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(f"range spec must be a:b:n, got {spec!r}")
        a, b, n = float(parts[0]), float(parts[1]), int(parts[2])
        return np.linspace(a, b, n, dtype=np.float32)
    if "," in spec:
        return np.asarray([float(v) for v in spec.split(",")], dtype=np.float32)
    v = float(spec)
    return np.full(count or 1, v, dtype=np.float32)


def render_sweep(res: EnsembleResult, output: str) -> str:
    """Plot the per-instance av_vels families + the final-value curve
    (the ensemble analog of the reference's parameter-study figures)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    B = res.omegas.size
    # Label by whichever parameter varies; a geometry sweep (constant
    # omega AND accel) falls back to instance indices.
    if np.unique(res.omegas).size > 1:
        name, labels = "omega", res.omegas
    elif np.unique(res.accels).size > 1:
        name, labels = "accel", res.accels
    else:
        name, labels = "instance", np.arange(B, dtype=np.float32)
    cmap = plt.get_cmap("viridis")
    for i in range(B):
        ax1.plot(
            res.av_vels[:, i],
            color=cmap(i / max(1, B - 1)),
            label=f"{name}={labels[i]:.4g}",
            linewidth=1.0,
        )
    ax1.set_xlabel("step")
    ax1.set_ylabel("av_velocity")
    ax1.set_title("av_vels per instance")
    if B <= 10:
        ax1.legend(fontsize=7)
    final = (
        res.av_vels[-1]
        if res.av_vels.shape[0]
        else np.full(B, np.nan, dtype=np.float32)
    )
    ax2.plot(labels, final, "o-")
    ax2.set_xlabel(name)
    ax2.set_ylabel("final av_velocity")
    ax2.set_title(f"final av vs {name}")
    fig.tight_layout()
    fig.savefig(output, dpi=120)
    plt.close(fig)
    return output
