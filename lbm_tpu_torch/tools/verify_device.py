"""On-card correctness artifact: ``python -m lbm_tpu_torch.tools.verify_device``.

The counterpart of ``lbm_tpu/tools/verify_device.py`` (``VERIFY_TPU.json``).
It writes ``VERIFY_H100.json`` (or ``$LBM_VERIFY_OUT``) and prints the same
report as one JSON line:

- one probe per CUDA kernel form of PERF.md's kernel table (22: K1 to K10
  with their int16, slab and ca forms, and the ensemble's K1-batch,
  K2-batch and K11), each holding the kernel's wrapper
  against the twin (``ops/fused_torch.py``, the plain version every kernel
  is built to equal) on one recipe (:func:`_recipe`: a closed box with an
  interior block, a wall on the driven row, from a seeded perturbation of
  rest with the driven row's injection guard false at every third cell).
  The single-grid kernels take the twin's run of the same steps (the sweeps
  and their int16 forms with the twin's quantization once per sweep); the
  slab and ca kernels one shard of the grid over 4 with its ghost rows cut
  from the same state, against those rows of the twin's run on the whole
  grid (one step for K1-slab, K steps for the ca engines, which are exact);
  K6 k steps with its ghost rows frozen, against k twin slab steps with the
  same frozen ghosts; K1-batch, K2-batch and K11 B instances of the recipe
  (omegas 1.3 to 1.9, accels 0.01 and 0.005 in turn) against the plain
  batched step (``ops/ensemble_cuda.run_plain``).  Shapes are those the
  smoke test's kernel phases map
  (K9 where ``hbm_cuda.plan`` finds parts, K7 and K8 on the 256x1024 shard
  of 1024^2 over 4, K6 on the same shard);
- a golden prefix, float32 and int16: the 1024^2 reference scene rebuilt
  from ``golden/`` (wall cells from column 7 of the final state, density
  0.1, accel 0.01, omega 1.85), run through ``run_simulation`` under the
  default policy, its av_vels against the golden series (within 1%);
- the card (nvidia-smi's name and power limit), the torch and CUDA
  versions, the commit (git's, else ``$LBM_COMMIT``) and a digest of the
  package's sources.

``regime`` is ``card`` on a CUDA device: each probe must have max |diff| 0
(fields, int16 in quantization steps).  ``--device cpu`` runs the
``cpu-plain`` regime: the wrappers run their plain versions (no kernel can
run), held against the twin at reduced extents within ``tolerance``, and the
golden prefix is shorter, as ``lbm_tpu`` runs its probes under interpret
mode.  ``ok`` is true when every probe is within its regime's tolerance and
both golden prefixes are under 1%.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from lbm_tpu_torch.ops import _build

_REPO = pathlib.Path(__file__).resolve().parents[2]
GOLDEN = _REPO / "golden"
SHARDS = 4  # the slab and ca probes take the last shard of the grid over 4

# The 22 kernel forms of PERF.md's kernel table, in its order.
PROBES = _build.KERNEL_FORMS

# Tolerances on max |diff| (float32 fields; int16 fields in quantization
# steps): the card's claim is bitwise; on the CPU the plain versions are
# held to 5e-7, lbm_tpu's interpret-mode budget, and int16 to 0 steps.
TOLERANCE = {"card": {"f32": 0.0, "i16": 0.0}, "cpu-plain": {"f32": 5e-7, "i16": 0.0}}


@dataclasses.dataclass(frozen=True)
class Extents:
    """The probes' shapes in one regime (n x n grids)."""

    grid: int  # K3, K3-i16, K10 and the shards of the slab and ca kernels
    k1: int  # K1
    big: int  # K1-i16, the sweeps and K9
    small: int  # K2
    steps: int  # the persistent kernels (K2, K3, K10): more than one launch
    golden_steps: int
    instances: int  # K1-batch (on ``grid``), K2-batch and K11 (on ``small``)


CARD = Extents(grid=1024, k1=1536, big=2048, small=256, steps=300, golden_steps=120,
               instances=4)
CPU = Extents(grid=64, k1=48, big=64, small=32, steps=20, golden_steps=8, instances=3)


def _recipe(n: int, dev: torch.device, accel: float = 0.01):
    """(params, obstacle mask on ``dev``, f0 on ``dev``): an n x n closed
    box with an interior block and a wall on the driven row (ny - 2), from
    a seeded 10% perturbation of rest with the driven row's injection guard
    false at every third cell."""
    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.params import LBMParams

    p = LBMParams(nx=n, ny=n, max_iters=100, reynolds_dim=10, density=0.1, accel=accel,
                  omega=1.85)
    m = np.zeros((n, n), dtype=bool)
    m[0, :] = m[-1, :] = True
    m[:, 0] = m[:, -1] = True
    m[n // 3: n // 3 + max(2, n // 16), n // 4: n // 4 + max(2, n // 16)] = True
    m[n - 2, n // 2] = True
    rng = np.random.default_rng(5)
    noise = rng.uniform(-0.1, 0.1, size=(9, n, n)).astype(np.float32)
    f = lattice.equilibrium_rest(p.density, n, n) * (np.float32(1.0) + noise)
    w1, _ = lattice.accel_weights(p.density, p.accel)
    f[3, p.accel_row, ::3] = w1 * np.float32(0.5)
    return p, torch.from_numpy(m).to(dev), torch.from_numpy(f).to(dev)


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


class _Probes:
    """The probes of one regime; twin runs of one recipe are shared."""

    def __init__(self, ext: Extents, dev: torch.device):
        self.ext, self.dev = ext, dev
        self._twins: dict = {}

    def recipe(self, n: int, storage: str):
        from lbm_tpu_torch.ops import quant

        p, obst, f0 = _recipe(n, self.dev)
        return p, obst, (quant.quantize(f0, p.density) if storage == "i16" else f0)

    def twin(self, n: int, storage: str, steps: int, K: int = 1) -> torch.Tensor:
        """The twin's state after ``steps`` steps of the n x n recipe (K-step
        sweeps: int16 quantized once per sweep)."""
        from lbm_tpu_torch.ops import fused_torch

        key = (n, storage, steps, K)
        if key not in self._twins:
            p, obst, s0 = self.recipe(n, storage)
            self._twins[key] = (fused_torch.run_sweeps(s0, obst, p, steps, K, storage)[0] if K > 1
                                else fused_torch.run_steps(s0, obst, p, steps, storage)[0])
        return self._twins[key]

    def single(self, name: str, n: int, storage: str, steps: int, run_all, K: int = 1):
        """A kernel over the whole grid, ``run_all(p, obst) -> runner``."""
        p, obst, s0 = self.recipe(n, storage)
        out, _ = run_all(p, obst)(s0)
        return {"shape": f"{n}x{n}", "steps": steps,
                "max_abs": _maxdiff(out, self.twin(n, storage, steps, K)),
                "reference": f"twin, {steps} steps" + (f" in {K}-step sweeps" if K > 1 else "")}

    def shard(self, storage: str, depth: int):
        """(params, body, lo, hi, obst slab, row offset, ny) of the last of
        ``SHARDS`` shards of the grid recipe, ``depth`` ghost rows a side."""
        n = self.ext.grid
        p, obst, s0 = self.recipe(n, storage)
        nloc = n // SHARDS
        r0 = (SHARDS - 1) * nloc
        rows = torch.arange(r0 - depth, r0 + nloc + depth, device=self.dev) % n
        ext = s0[:, rows]
        return (p, ext[:, depth:depth + nloc].contiguous(), ext[:, :depth].contiguous(),
                ext[:, depth + nloc:].contiguous(), obst[rows].contiguous(), r0, n)

    def slab(self, storage: str):
        from lbm_tpu_torch.ops import fused_cuda

        p, body, lo, hi, ob, r0, n = self.shard(storage, 1)
        out = torch.empty_like(body)
        tots = torch.zeros(1, dtype=torch.float32, device=self.dev)
        fused_cuda.bind_slab_step(p, body, lo, hi, ob, out, tots, r0, storage)(0)
        ref = self.twin(n, storage, 1)[:, r0:r0 + body.shape[1]]
        return {"shape": f"{body.shape[1]}x{n} shard of {n}x{n}", "steps": 1,
                "max_abs": _maxdiff(out, ref), "reference": "twin, 1 step of the whole grid"}

    def ca(self, name: str, storage: str, K: int):
        """One ca sweep of the shard on ``name``'s engine; exact, so it
        equals the shard's rows of K twin steps of the whole grid."""
        from lbm_tpu_torch.ops import ca_cuda, temporal_cuda

        p, body, lo, hi, ob, r0, n = self.shard(storage, K)
        out = torch.empty_like(body)
        tots = torch.zeros(K, dtype=torch.float32, device=self.dev)
        if name.startswith("K4-slab"):
            temporal_cuda.bind_slab_sweep(p, lo, body, hi, ob, out, tots, r0, n, storage)(0)
            ref, how = self.twin(n, storage, K, K), f"{K}-step sweep"
        elif name == "K7":
            ca_cuda.bind_resident(p, lo, body, hi, ob, out, tots, r0, n)(0)
            ref, how = self.twin(n, storage, K), f"{K} steps"
        else:
            ca_cuda.bind_inplace(p, lo, body, hi, ob, out, tots, r0, n, storage)(0)
            ref, how = self.twin(n, storage, K), f"{K} steps"
        return {"shape": f"{body.shape[1]}x{n} shard of {n}x{n}, K={K}", "steps": K,
                "max_abs": _maxdiff(out, ref[:, r0:r0 + body.shape[1]]),
                "reference": f"twin, {how} of the whole grid"}

    def k6(self, chunk: int = 2):
        """One K6 launch of ``chunk`` steps, ghosts frozen, against as many
        twin slab steps with the same ghosts."""
        from lbm_tpu_torch.ops import fused_torch, ghosted_cuda

        p, body, lo, hi, ob, r0, n = self.shard("f32", 1)
        a, b = body.clone(), torch.empty_like(body)
        tots = torch.zeros(chunk, dtype=torch.float32, device=self.dev)
        launch = ghosted_cuda.bind_chunk(p, a, lo, hi, ob, b, tots, r0, chunk)
        launch(0)
        ref = body
        for _ in range(chunk):
            ref, _ = fused_torch.fused_step_slab(torch.cat([lo, ref, hi], dim=1), ob, p, r0)
        return {"shape": f"{body.shape[1]}x{n} shard of {n}x{n}, k={chunk}", "steps": chunk,
                "max_abs": _maxdiff(launch.result, ref),
                "reference": f"twin, {chunk} slab steps with the ghosts frozen"}

    def ensemble(self, kernel: str, n: int, steps: int):
        """An ensemble kernel on ``instances`` instances of the n x n
        recipe against the plain batched step."""
        from lbm_tpu_torch.ops import ensemble_cuda

        B = self.ext.instances
        p, obst, f0 = self.recipe(n, "f32")
        f0_b = f0.unsqueeze(0).expand(B, -1, -1, -1).contiguous()
        omegas = np.linspace(1.3, 1.9, B, dtype=np.float32)
        accels = np.asarray([(0.01, 0.005)[b % 2] for b in range(B)], dtype=np.float32)
        out, _ = ensemble_cuda.make_run_all(p, obst, omegas, accels, steps, kernel=kernel)(f0_b)
        ref, _ = ensemble_cuda.run_plain(f0_b, obst, p, omegas, accels, steps)
        return {"shape": f"{B} x {n}x{n}", "steps": steps, "max_abs": _maxdiff(out, ref),
                "reference": f"the plain batched step, {steps} steps"}

    def run(self, name: str) -> dict:
        from lbm_tpu_torch.ops import (
            blocked_cuda,
            fused_cuda,
            hbm_cuda,
            inplace_cuda,
            resident_cuda,
            skew_cuda,
            temporal_cuda,
        )

        e = self.ext
        short, K = 16 if e is CARD else 6, 4
        sweep_steps = 2 * K + 1  # two sweeps and a K1 tail
        storage = "i16" if name.endswith("-i16") else "f32"
        base = name.removesuffix("-i16")
        if base == "K1":
            n = e.k1 if storage == "f32" else e.big
            return self.single(name, n, storage, short, lambda p, o: fused_cuda.make_run_all(
                p, o, short, storage))
        if base == "K1-slab":
            return self.slab(storage)
        if name == "K2":
            return self.single(name, e.small, "f32", e.steps,
                               lambda p, o: resident_cuda.make_run_all(p, o, e.steps))
        if base == "K3":
            return self.single(name, e.grid, storage, e.steps, lambda p, o: (
                inplace_cuda.make_run_all(p, o, e.steps, storage=storage)))
        if base in ("K4", "K5"):
            mod = temporal_cuda if base == "K4" else skew_cuda
            return self.single(name, e.big, storage, sweep_steps, lambda p, o: mod.make_run_all(
                p, o, sweep_steps, K, storage), K if storage == "i16" else 1)
        if base == "K4-slab" or name == "K7":
            return self.ca(name, storage, 4)
        if base == "K8":
            return self.ca(name, storage, 8)
        if name == "K6":
            return self.k6()
        if name == "K9":
            return self.single(name, e.big, "f32", sweep_steps,
                               lambda p, o: hbm_cuda.make_run_all(p, o, sweep_steps, K))
        if name == "K10":
            return self.single(name, e.grid, "f32", e.steps,
                               lambda p, o: blocked_cuda.make_run_all(p, o, e.steps))
        if name == "K1-batch":
            return self.ensemble(name, e.grid, short)
        if name in ("K2-batch", "K11"):
            return self.ensemble(name, e.small, e.steps)
        raise ValueError(f"unknown probe {name!r}")


def golden_scene(root: pathlib.Path = GOLDEN):
    """The 1024^2 reference scene: wall cells from column 7 of
    ``1024x1024.final_state.dat.gz``, density 0.1, accel 0.01, omega 1.85,
    20000 steps (the parameters that reproduce the golden av_vels)."""
    from lbm_tpu_torch.io.scene import Scene
    from lbm_tpu_torch.params import LBMParams

    cells = np.loadtxt(root / "1024x1024.final_state.dat.gz", usecols=[0, 1, 6], dtype=np.int64)
    walls = cells[cells[:, 2] != 0]
    mask = np.zeros((1024, 1024), dtype=bool)
    mask[walls[:, 1], walls[:, 0]] = True
    params = LBMParams(nx=1024, ny=1024, max_iters=20000, reynolds_dim=10, density=0.1,
                       accel=0.01, omega=1.85)
    return Scene(params, mask)


def golden_prefix(scene, steps: int, storage: str, device: str,
                  root: pathlib.Path = GOLDEN) -> tuple[float, str]:
    """(max per-step av_vels difference from the golden series in percent,
    the variant that ran) over the first ``steps`` steps."""
    from lbm_tpu_torch.models.driver import RunConfig, run_simulation

    res = run_simulation(scene, RunConfig(device=device, num_steps=steps, storage=storage))
    gold = np.loadtxt(root / "1024x1024.av_vels.dat.gz", usecols=[1], max_rows=steps)
    return float(np.max(np.abs(100.0 * (res.av_vels - gold) / gold))), res.variant


def source_digest() -> str:
    """sha256 over the package's Python and CUDA sources, by relative path:
    names the code that ran where the checkout is not a git repository."""
    h = hashlib.sha256()
    pkg = _REPO / "lbm_tpu_torch"
    for path in sorted(pkg.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh") and "__pycache__" not in path.parts:
            h.update(str(path.relative_to(pkg)).encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def _commit() -> str | None:
    try:
        out = subprocess.run(["git", "-C", str(_REPO), "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=30)
    except OSError:
        out = None
    if out is not None and out.returncode == 0:
        return out.stdout.strip()
    return os.environ.get("LBM_COMMIT") or None


def run_verify(device: str = "cuda", probes=PROBES) -> dict:
    """Every probe and both golden prefixes on ``device`` (``cuda``: the
    card regime; ``cpu``: the plain versions at reduced extents)."""
    from lbm_tpu_torch.models.driver import resolve_device
    from lbm_tpu_torch.tools.bench import card_line

    dev = resolve_device(device)
    regime = "card" if dev.type == "cuda" else "cpu-plain"
    ext = CARD if regime == "card" else CPU
    tol = TOLERANCE[regime]
    report: dict = {
        "regime": regime,
        "card": card_line() if regime == "card" else None,
        "device": torch.cuda.get_device_name(dev) if regime == "card" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "commit": _commit(),
        "sources_sha256": source_digest(),
        "tolerance": tol,
        "probes": {},
    }
    runner = _Probes(ext, dev)
    ok = True
    for name in probes:
        res = runner.run(name)
        res["bitwise"] = res["max_abs"] == 0.0
        res["ok"] = res["max_abs"] <= tol["i16" if name.endswith("-i16") else "f32"]
        report["probes"][name] = res
        ok = ok and res["ok"]
    del runner
    scene = golden_scene()
    for storage, key in (("f32", "golden_prefix"), ("i16", "golden_prefix_i16")):
        pct, variant = golden_prefix(scene, ext.golden_steps, storage, str(dev))
        report[key] = {"steps": ext.golden_steps, "variant": variant, "max_pct": pct,
                       "ok": pct < 1.0}
        ok = ok and pct < 1.0
    report["ok"] = bool(ok)
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (the card regime, the default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    out_path = os.environ.get("LBM_VERIFY_OUT", "VERIFY_H100.json")
    try:
        report = run_verify(args.device)
    except Exception as e:  # record the failure in the artifact, do not hide it
        report = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    with open(out_path, "w") as fp:
        json.dump(report, fp, indent=1)
        fp.write("\n")
    print(json.dumps(report))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
