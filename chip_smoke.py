#!/usr/bin/env python3
"""On-card smoke test of lbm_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, anchors the main path to the numpy
oracle, drives the CLI end to end, and times kernels and twin.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; every number sits beside the card's name and
power limit as nvidia-smi reports them):

1. the card, torch and CUDA versions, and the kernel build;
2. K1 (one-step kernel) vs its plain version: 1024x1024 and 60x100 closed
   boxes with an interior block and the driven row, 50 steps, from rest and
   (60x100) from a seeded random perturbation of rest with the injection
   guard false at some driven-row cells; fields torch.equal, per-step tot_u
   within rtol 1e-6;
3. K2 (persistent multi-step kernel) vs its plain version: 128x128, 256x128,
   256x256 with (steps, chunk) in {(7,4), (8,4), (5,8), (600,256)}, and
   256x256 from the perturbed state for 600 steps; same bounds;
4. the cuda main path on a 128x128 scene for 120 steps vs core/oracle:
   fields atol 2e-7, av rtol 1e-4;
5. ``lbm_tpu_torch run`` on 256x256 (8000 steps: K2, two segments) and
   1024x1024 (2000 steps: K1) as --variant cuda and --variant torch;
   ``check`` of cuda against torch must pass; the launch counters, zeroed
   just before the cuda runs, must have gone up;
6. MLUPS of those runs, and K1 / K2 / twin times at 128^2 .. 1024^2
   (tools/kernel_times.py) beside a 1 GiB device copy's bandwidth;
7. one JSON line of kernel findings, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no final line.  It
does the same when no CUDA device is present, and when the package is not
beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

GRID_SIZES = (128, 256, 512, 1024)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def box_scene(ny: int, nx: int, accel: float = 0.005):
    """Closed box (walls on all four sides) with an interior block; the
    driven row ny-2 runs through it."""
    import numpy as np

    from lbm_tpu_torch.params import LBMParams

    p = LBMParams(nx=nx, ny=ny, max_iters=100, reynolds_dim=10,
                  density=0.1, accel=accel, omega=1.85)
    m = np.zeros((ny, nx), dtype=bool)
    m[0, :] = m[-1, :] = True
    m[:, 0] = m[:, -1] = True
    m[ny // 3: ny // 3 + max(2, ny // 16), nx // 4: nx // 4 + max(2, nx // 16)] = True
    # a wall cell on the driven row itself, so the injection guard sees one
    m[ny - 2, nx // 2] = True
    return p, m


def mixed_state(p, dev):
    """The rest state with a seeded random 10% perturbation, and the driven
    row's injection guard false at every third cell: the rows next to the
    driven row, which pull injected values, are where a wrong guard shows."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice

    rng = np.random.default_rng(5)
    noise = rng.uniform(-0.1, 0.1, size=(9, p.ny, p.nx)).astype(np.float32)
    f = lattice.equilibrium_rest(p.density, p.ny, p.nx) * (np.float32(1.0) + noise)
    w1, _ = lattice.accel_weights(p.density, p.accel)
    f[3, p.accel_row, ::3] = w1 * np.float32(0.5)
    return torch.from_numpy(f).to(dev)


def compare(name: str, f_k, tot_k, f_p, tot_p) -> tuple[float, float]:
    """Fields must be bitwise equal, per-step tot_u within rtol 1e-6."""
    import torch

    if not (bool(torch.isfinite(f_k).all()) and bool(torch.isfinite(f_p).all())):
        fail(f"{name}: non-finite state")
    err = float((f_k - f_p).abs().max())
    if not torch.equal(f_k, f_p):
        fail(f"{name}: fields differ from the plain version (max |diff| {err:.3e})")
    rel = float(((tot_k - tot_p).abs() / tot_p.abs().clamp_min(1e-30)).max()) if len(tot_p) else 0.0
    if not torch.allclose(tot_k, tot_p, rtol=1e-6, atol=0.0):
        fail(f"{name}: per-step tot_u off the plain version by {rel:.3e} relative")
    return err, rel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    import numpy as np

    from lbm_tpu_torch import cli
    from lbm_tpu_torch.core import lattice, oracle
    from lbm_tpu_torch.io.scene import Scene
    from lbm_tpu_torch.models.driver import RunConfig, run_simulation
    from lbm_tpu_torch.ops import _build, fused_cuda, resident_cuda
    from lbm_tpu_torch.params import LBMParams
    from lbm_tpu_torch.tools import bench, kernel_times, scenegen

    dev = torch.device("cuda", 0)
    card = bench.card_line()
    if card is None:
        fail("nvidia-smi is missing: cannot name the card")
    kind = torch.cuda.get_device_name(0)

    # Phase 1: card, versions, build.
    print(card)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in (_build.build_dir() / "nvcc.log").read_text().splitlines()
            if "registers" in ln]
    print(f"[1 build] card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} "
          f"| kernels built in {build_s:.2f} s | ptxas: {'; '.join(regs)}")

    def field(ny, nx, accel=0.005):
        p, m = box_scene(ny, nx, accel)
        return p, m, torch.from_numpy(m).to(dev), lattice.equilibrium_rest_device(
            p.density, ny, nx, dev)

    # Phase 2: K1 vs plain.
    k1_err, k1_rel, notes = 0.0, 0.0, []
    for ny, nx, start in ((1024, 1024, "rest"), (60, 100, "rest"), (60, 100, "mixed")):
        p, _, obst, f0 = field(ny, nx, 0.01 if ny >= 1024 else 0.005)
        if start == "mixed":
            f0 = mixed_state(p, dev)
        f_k, tot_k = fused_cuda.make_run_all(p, obst, 50)(f0)
        f_p, tot_p = fused_cuda.run_plain(f0, obst, p, 50)
        e, r = compare(f"K1 {ny}x{nx} {start}", f_k, tot_k, f_p, tot_p)
        k1_err, k1_rel = max(k1_err, e), max(k1_rel, r)
        notes.append(f"{ny}x{nx} {start} start: equal, tot_u rel {r:.2e}")
    print(f"[2 K1 vs plain] card: {card} | 50 steps | " + "; ".join(notes))

    # Phase 3: K2 vs plain.
    k2_err, k2_rel, n_cases = 0.0, 0.0, 0
    for ny, nx in ((128, 128), (256, 128), (256, 256)):
        p, _, obst, f0 = field(ny, nx)
        for steps, chunk in ((7, 4), (8, 4), (5, 8), (600, 256)):
            f_k, tot_k = resident_cuda.make_run_all(p, obst, steps, chunk=chunk)(f0)
            f_p, tot_p = resident_cuda.run_plain(f0, obst, p, steps)
            e, r = compare(f"K2 {ny}x{nx} steps={steps} chunk={chunk}", f_k, tot_k, f_p, tot_p)
            k2_err, k2_rel = max(k2_err, e), max(k2_rel, r)
            n_cases += 1
    f0 = mixed_state(p, dev)  # the last grid, 256x256, from a mixed-guard start
    f_k, tot_k = resident_cuda.make_run_all(p, obst, 600)(f0)
    f_p, tot_p = resident_cuda.run_plain(f0, obst, p, 600)
    e, r = compare("K2 256x256 mixed start", f_k, tot_k, f_p, tot_p)
    k2_err, k2_rel = max(k2_err, e), max(k2_rel, r)
    print(f"[3 K2 vs plain] card: {card} | {n_cases} cases (128x128, 256x128, 256x256 "
          f"x (7,4) (8,4) (5,8) (600,256)) + 256x256 mixed start 600 steps: "
          f"fields equal, tot_u max rel {k2_rel:.2e}")

    # Phase 4: oracle anchor on the cuda main path.
    p128 = LBMParams(nx=128, ny=128, max_iters=120, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85)
    scene128 = Scene(p128, scenegen.make_mask("cylinder", 128, 128))
    res = run_simulation(scene128, RunConfig(variant="cuda", device="cuda"))
    f_o, av_o = oracle.run(p128, scene128.obstacles, num_steps=120)
    f_dev = float(np.abs(res.f - f_o).max())
    av_rel = float(np.max(np.abs(res.av_vels - av_o) / np.abs(av_o)))
    if not (f_dev <= 2e-7 and av_rel <= 1e-4):
        fail(f"oracle anchor: max |df| {f_dev:.3e} (atol 2e-7), av rel {av_rel:.3e} (rtol 1e-4)")
    print(f"[4 oracle anchor] card: {card} | {res.variant} 128x128 cylinder, 120 steps: "
          f"max |df| {f_dev:.3e} <= 2e-7, av max rel {av_rel:.3e} <= 1e-4")

    # Phase 5: end to end through the CLI, in this process so the launch
    # counters of the main path can be read.
    mlups: dict[str, float] = {}
    k1_launches = k2_launches = 0
    with tempfile.TemporaryDirectory() as td:
        runs = []
        for n, steps, preset in ((256, 8000, "cylinder"), (1024, 2000, "channel")):
            params = LBMParams(nx=n, ny=n, max_iters=steps, reynolds_dim=10,
                                        density=0.1, accel=0.01 if n >= 1024 else 0.005,
                                        omega=1.85)
            pfile, ofile = scenegen.write_scene(td, preset, params)
            runs.append((f"{n}x{n}", steps, pfile, ofile))

        def cli_run(tag, steps, pfile, ofile, variant):
            out_dir = os.path.join(td, f"{tag}-{variant}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["run", pfile, ofile, "--variant", variant, "--device", "cuda",
                               "--steps", str(steps), "--out-dir", out_dir])
            text = buf.getvalue()
            if rc != 0:
                fail(f"run {tag} --variant {variant} exited {rc}:\n{text}")
            rate = [ln for ln in text.splitlines() if ln.startswith("Compute rate:")]
            mlups[f"{tag} {variant}"] = float(rate[0].split()[-2])
            return out_dir

        fused_cuda.LAUNCHES = 0
        resident_cuda.LAUNCHES = 0
        cuda_dirs = {tag: cli_run(tag, steps, pf, of, "cuda") for tag, steps, pf, of in runs}
        k1_launches, k2_launches = fused_cuda.LAUNCHES, resident_cuda.LAUNCHES
        if k1_launches <= 0 or k2_launches <= 0:
            fail(f"main path skipped a kernel: K1 launches {k1_launches}, K2 {k2_launches}")
        torch_dirs = {tag: cli_run(tag, steps, pf, of, "torch") for tag, steps, pf, of in runs}
        checks = []
        for tag, *_ in runs:
            a, b = cuda_dirs[tag], torch_dirs[tag]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["check",
                               "--ref-av-vels-file", os.path.join(b, "av_vels.dat"),
                               "--ref-final-state-file", os.path.join(b, "final_state.dat"),
                               "--av-vels-file", os.path.join(a, "av_vels.dat"),
                               "--final-state-file", os.path.join(a, "final_state.dat")])
            if rc != 0 or "Both tests passed!" not in buf.getvalue():
                fail(f"check {tag} cuda vs torch failed (rc {rc}):\n{buf.getvalue()}")
            # Fields are bitwise equal, so the final states are byte-identical;
            # av_vels differ only by the order of the |u| sums.
            with open(os.path.join(a, "final_state.dat"), "rb") as fa, \
                    open(os.path.join(b, "final_state.dat"), "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"{tag}: cuda and torch final_state.dat differ")
            checks.append(f"{tag} passed, final_state.dat byte-identical")
    print(f"[5 CLI end to end] card: {card} | 256x256 x 8000 steps, 1024x1024 x 2000 steps | "
          f"check cuda vs torch: {'; '.join(checks)} | launches K1 {k1_launches}, "
          f"K2 {k2_launches}")

    # Phase 6: rates.
    print(f"[6a run MLUPS] card: {card} | "
          + "; ".join(f"{k} {v:.1f}" for k, v in mlups.items()))
    gbps = kernel_times.copy_gbps(dev, repeats=5)
    table = {n: kernel_times.time_grid(n, dev, repeats=5) for n in GRID_SIZES}
    print(f"[6b us/step: median [q1, q3], MLUPS, GB/s] card: {card} | "
          f"copy 1 GiB {gbps[0]:.1f} GB/s | "
          + " ; ".join(kernel_times.format_grid(n, t) for n, t in table.items()))

    # Phase 7: kernel findings, then the last line.
    k1_ms, k1_plain = table[1024]["K1"][0] / 1e3, table[1024]["twin"][0] / 1e3
    k2_step_ms, k2_plain_step = table[256]["K2"][0] / 1e3, table[256]["twin"][0] / 1e3
    kernels = [
        {"name": "K1 one-step fused kernel (ms per launch = 1 step, 1024x1024)",
         "route": "cuda", "source": "lbm_tpu_torch/csrc/step.cu",
         "replaces": "lbm_tpu/ops/fused_pallas.py:249",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 persistent multi-step kernel (ms per launch = 256 steps, 256x256)",
         "route": "cuda", "source": "lbm_tpu_torch/csrc/resident.cu",
         "replaces": "lbm_tpu/ops/resident_pallas.py:213",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_step_ms * resident_cuda.DEFAULT_CHUNK,
         "plain_ms": k2_plain_step * resident_cuda.DEFAULT_CHUNK},
    ]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
