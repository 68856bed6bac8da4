"""Benchmark runner: MLUPS of one grid and variant, with baseline comparison.

The counterpart of ``lbm_tpu/tools/bench.py``.  It times the compute phase
of ``run_simulation`` (kernel build and first launch excluded, like the
reference's Compute bracket, SerialCode/d2q9-bgk.c:161-184), keeps the best
of ``repeats`` runs, and reports MLUPS with the ratio to the reference's
best (fully-async MPI, 80 cores) number for that grid, in the same one-line
JSON as ``lbm_tpu bench`` plus the device it ran on.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np

# Reference best (fully-async MPI_Testall, 80 cores) MLUPS per grid, derived
# from the reference README (see BASELINE.md).
REFERENCE_BEST_MLUPS = {
    "128x128": 1587.0,
    "128x256": 922.0,
    "256x256": 1530.0,
    "1024x1024": 1796.0,
}


def card_line() -> str | None:
    """First card's name and power limit as nvidia-smi reports them, or None
    where nvidia-smi is missing."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0] if out.strip() else None


def make_scene(grid: str):
    """A closed-box scene with the reference scenes' parameters for ``grid``
    (full border blocked; maxIters and accel as in the reference inputs)."""
    from lbm_tpu_torch.io.scene import Scene
    from lbm_tpu_torch.params import LBMParams

    nx, ny = (int(v) for v in grid.split("x"))
    iters = {"128x128": 40000, "128x256": 40000, "256x256": 80000}.get(grid, 20000)
    accel = 0.01 if max(nx, ny) >= 1024 else 0.005
    params = LBMParams(
        nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
        density=0.1, accel=accel, omega=1.85,
    )
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return Scene(params=params, obstacles=mask)


def run_bench(
    grid: str = "1024x1024",
    variant: str = "auto",
    steps: int | None = None,
    repeats: int = 3,
    device: str = "cuda",
    storage: str = "f32",
) -> dict:
    from lbm_tpu_torch.models.driver import RunConfig, run_simulation

    scene = make_scene(grid)
    num_steps = steps if steps is not None else scene.params.max_iters
    config = RunConfig(variant=variant, device=device, num_steps=num_steps, storage=storage)

    best = None
    for _ in range(max(1, repeats)):
        result = run_simulation(scene, config)
        if best is None or result.mlups > best.mlups:
            best = result

    baseline = REFERENCE_BEST_MLUPS.get(grid)
    return {
        "metric": f"MLUPS {grid} {best.variant}",
        "storage": storage,
        "value": round(best.mlups, 1),
        "unit": "MLUPS",
        "vs_baseline": round(best.mlups / baseline, 3) if baseline else None,
        "grid": grid,
        "steps": num_steps,
        "variant": best.variant,
        "compute_s": round(best.timer.elapsed.get("compute", 0.0), 4),
        "reynolds": best.reynolds,
        "device": best.device,
        "card": card_line() if best.device != "cpu" else None,
    }
