"""Sync-vs-async divergence probe (``run --divergence``).

The counterpart of ``lbm_tpu/tools/divergence.py``: the synchronous and the
stale-halo program run side by side on the run's shards
(``modes.build_sharded_program``), and every step records the average
velocity of each, the relative L-infinity norm of the field difference
(max|f_s - f_a| / max|f_s|) and its RMS, so the accuracy cost of a
staleness is observed directly rather than only at the end of a run.

The field is never gathered: every step each shard reduces its own real
rows (the seam's padding rows left out, as ``f_of`` drops them) to three
float32 partials, max|f_s - f_a|, max|f_s| and the sum of (f_s - f_a)^2.
They stay on the device and reach the host once, after the last step,
through one gather of every shard's series (``parallel/exchange.gather``;
the processes of a group, rank order = shard order).  The shards then
combine in global shard order: the maxima (exact in any order), and the
sums as ((S_0 + S_1) + S_2) + ..., over 9 ny nx, then the square root.  So
one process and a process group over the same global shards write the
same series bitwise.

Outputs: ``divergence.csv`` in ``lbm_tpu``'s columns (step, av_sync,
av_async, av_rel_pct, field_rel_linf, field_rms), and ``divergence.png``
where matplotlib imports.

Backend: ``lbm_tpu`` defaults to its plain ``jnp`` step, which XLA fuses on
a TPU.  Here the backend follows the run, as the sharded variants' does
(``modes.build_sharded_program``): the kernels (K1-slab) on a card and the
plain slab step on the CPU; ``backend="torch"`` forces the plain step,
which on a card is a test path, not a fast one.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.parallel import mesh as mesh_lib
from lbm_tpu_torch.parallel import modes
from lbm_tpu_torch.parallel.exchange import gather


@dataclasses.dataclass
class DivergenceResult:
    av_sync: np.ndarray  # (steps,)
    av_async: np.ndarray  # (steps,)
    field_rel_linf: np.ndarray  # (steps,) max|f_s - f_a| / max|f_s|
    field_rms: np.ndarray  # (steps,) rms of f_s - f_a
    mode: str
    staleness: int
    num_devices: int

    @property
    def av_rel_pct(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return 100.0 * np.abs(self.av_async - self.av_sync) / self.av_sync

    def summary(self) -> str:
        return (
            f"divergence over {len(self.av_sync)} steps "
            f"({self.mode}, staleness={self.staleness}, "
            f"{self.num_devices} shards): "
            f"max av deviation {np.nanmax(self.av_rel_pct):.4f}%, "
            f"final field Linf {self.field_rel_linf[-1]:.3e}, "
            f"final field rms {self.field_rms[-1]:.3e}"
        )


def run_divergence(
    scene: Scene,
    num_devices: int | None = None,
    mode: str = "async",
    staleness: int = 1,
    num_steps: int | None = None,
    backend: str | None = None,
    device: str | torch.device = "cuda",
    host_devices: int | None = None,
) -> DivergenceResult:
    """Run sync and async side by side over the run's row mesh
    (``mesh.run_mesh``: ``num_devices`` of ``device``'s devices,
    ``host_devices`` the one device counted N times; in a process group
    ``host_devices`` shards on every process); returns the per-step
    deviation, on every rank alike.  ``backend`` None follows the device."""
    params = scene.params
    steps = num_steps if num_steps is not None else params.max_iters
    if mode not in ("async",):
        raise ValueError(f"--divergence probes the stale-halo modes; got mode={mode!r}")
    mesh = mesh_lib.run_mesh(num_devices, device, host_devices)
    sync_prog = modes.build_sharded_program(params, scene.obstacles, mesh, mode="sync",
                                            backend=backend)
    async_prog = modes.build_sharded_program(params, scene.obstacles, mesh, mode=mode,
                                             staleness=staleness, backend=backend)
    # One-step runners, each fed its own last state (the driver's --debug
    # schedule); every rank calls them in the same order, so their
    # exchanges and sums pair up across the processes.
    run_sync, run_async = sync_prog.make_run_all(1), async_prog.make_run_all(1)
    ny, nx = scene.obstacles.shape
    nloc = sync_prog.global_shape[0] // mesh.size
    # This process's shards' real rows (the last shards' padding rows out).
    real = [min(max(ny - (mesh.first + l) * nloc, 0), nloc) for l in range(mesh.local)]
    dev0 = mesh.devices[0]
    tots = torch.zeros((2, steps), dtype=torch.float32, device=dev0)
    parts = [torch.zeros((3, steps), dtype=torch.float32, device=d) for d in mesh.devices]
    ss, sa = sync_prog.init_state, async_prog.init_state
    for t in range(steps):
        ss, tu_s = run_sync(ss)
        sa, tu_a = run_async(sa)
        tots[0, t] = tu_s[0]
        tots[1, t] = tu_a[0]
        for part, rows, xs, xa in zip(parts, real, ss.f, sa.f):
            if rows:
                fs = xs[:, :rows]
                d = (fs - xa[:, :rows]).abs()
                part[:, t] = torch.stack((d.max(), fs.abs().max(), torch.sum(d * d)))
    local = torch.stack([p.to(dev0) for p in parts])
    shards = torch.cat(gather(mesh, local)).cpu().numpy()  # (R, 3, steps), shard order
    sq = shards[0, 2].copy()
    for s in shards[1:, 2]:
        sq += s
    rms = np.sqrt(sq / np.float32(9 * ny * nx))
    rel_linf = shards[:, 0].max(axis=0) / shards[:, 1].max(axis=0)
    tu_s, tu_a = tots.cpu().numpy()
    cells = np.float32(sync_prog.tot_cells)
    return DivergenceResult(
        av_sync=tu_s / cells,
        av_async=tu_a / cells,
        field_rel_linf=rel_linf,
        field_rms=rms,
        mode=mode,
        staleness=staleness,
        num_devices=mesh.size,
    )


def write_csv(path: str | os.PathLike, res: DivergenceResult) -> None:
    with open(path, "w") as fh:
        fh.write("step,av_sync,av_async,av_rel_pct,field_rel_linf,field_rms\n")
        av_pct = res.av_rel_pct
        for t in range(len(res.av_sync)):
            fh.write(
                f"{t},{res.av_sync[t]:.9e},{res.av_async[t]:.9e},"
                f"{av_pct[t]:.6e},{res.field_rel_linf[t]:.6e},"
                f"{res.field_rms[t]:.6e}\n"
            )


def write_plot(path: str | os.PathLike, res: DivergenceResult) -> None:
    """A two-panel PNG of the series; raises ImportError without
    matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = np.arange(len(res.av_sync))
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
    ax1.plot(steps, res.av_rel_pct, lw=0.8)
    ax1.axhline(1.0, color="tab:red", ls="--", lw=0.8, label="1% contract")
    ax1.set_ylabel("av_velocity deviation (%)")
    ax1.set_yscale("log")
    ax1.legend(loc="lower right")
    ax1.set_title(
        f"sync vs {res.mode} (staleness={res.staleness}, "
        f"{res.num_devices} shards)"
    )
    ax2.plot(steps, res.field_rel_linf, lw=0.8, label="rel Linf")
    ax2.plot(steps, res.field_rms, lw=0.8, label="rms")
    ax2.set_xlabel("timestep")
    ax2.set_ylabel("field deviation")
    ax2.set_yscale("log")
    ax2.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
