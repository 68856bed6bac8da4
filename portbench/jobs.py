"""What a job kind hands the harness, and how a job's outputs are judged.

A job kind (``traffic/<kind>.py``) makes a cell's inputs from the seed
(:class:`Inputs`) and a runner that calls the program once, one job, and
returns what the user receives on the host (:class:`JobOut`).  Every
instance's final distributions and av_vels series are held to the plain
reference (``reference/lbm.py``) run on the same inputs: :func:`gaps`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Inputs(NamedTuple):
    """A cell's inputs: B instances of one grid from rest."""
    mask: np.ndarray  # (ny, nx) bool, wall cells
    omegas: np.ndarray  # (B,) float32
    accels: np.ndarray  # (B,) float32
    density: float
    reynolds_dim: int
    steps: int

    @property
    def instances(self) -> int:
        return int(self.omegas.size)


class JobOut(NamedTuple):
    f: np.ndarray  # (B, 9, ny, nx) final distributions
    av_vels: np.ndarray  # (steps, B)
    phases: dict | None  # the program's own init / compute / collate seconds, where it has them
    kernel: str  # the kernel the program's policy took


# The numbers a job is judged by, in the order they are printed.
CHECKS = ("f_gap", "av_gap")


def sample(instances: int, n: int | None, seed: int) -> np.ndarray:
    """The instances a run checks: ``n`` of them drawn from the seed (a
    stream of its own), in order, or all where ``n`` is None or not less."""
    if n is None or n >= instances:
        return np.arange(instances)
    return np.sort(np.random.default_rng([seed, 1]).choice(instances, n, replace=False))


def reference(inp: Inputs, device: str, idx=None, dtype=None,
              store=None) -> tuple[np.ndarray, np.ndarray]:
    """The plain reference's (f, av_vels) of the instances ``idx`` (all by
    default) of ``inp``, in float32 unless ``dtype`` says otherwise
    (``store``: the state rounded to that dtype after every step), returned
    as float32 and float64 host arrays."""
    import torch

    from portbench.reference import lbm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    idx = np.arange(inp.instances) if idx is None else idx
    wall = torch.from_numpy(np.ascontiguousarray(inp.mask)).to(device)
    with torch.no_grad():
        f, av = lbm.run(wall, inp.omegas[idx].astype(np.float64),
                        inp.accels[idx].astype(np.float64), inp.density, inp.steps,
                        dtype or torch.float32, store)
    return f.float().cpu().numpy(), av.cpu().numpy()


# The lattice speed of sound, 1/sqrt(3) cells a step: av_vels are mean
# speeds in lattice units, and their gap is measured in this unit.
C_S = 3.0 ** -0.5


def gaps(out: JobOut, ref_f: np.ndarray, ref_av: np.ndarray, idx=None) -> dict[str, float]:
    """The widest gap of each checked instance (``idx``, all by default)
    from the reference, the worst instance's: ``f_gap``, max |f - f_ref|
    over an instance's cells and speeds, over the largest |f_ref| of that
    instance, and ``av_gap``, max |av - av_ref| over its steps, over the
    lattice speed of sound.  A missing or non-finite output reads inf.

    The av gap is absolute: float32 rounding of distributions that stay near
    their rest values leaves a nearly fixed absolute error in the velocity,
    so a gap relative to av_vels itself swings with the flow's speed (at
    1024x1024 ten times wider for omega 1.3, whose flow is five times
    slower, than for omega 1.9) and no longer tells a sound run from one
    stored in int16."""
    B = ref_f.shape[0]
    idx = np.arange(B) if idx is None else idx
    if (out.f.shape[1:] != ref_f.shape[1:] or out.av_vels.shape[0] != ref_av.shape[0]
            or max(out.f.shape[0], out.av_vels.shape[1]) <= idx.max()):
        return {name: float("inf") for name in CHECKS}
    f, av = out.f[idx].astype(np.float64), out.av_vels[:, idx].astype(np.float64)
    f_scale = np.abs(ref_f).reshape(B, -1).max(axis=1)
    f_gap = np.abs(f - ref_f).reshape(B, -1).max(axis=1) / f_scale
    av_gap = np.abs(av - ref_av).max(axis=0) / C_S
    worst = lambda g: float(np.max(np.where(np.isfinite(g), g, np.inf)))  # noqa: E731
    return {"f_gap": worst(f_gap), "av_gap": worst(av_gap)}
