"""Dry run of the sharded disciplines on P shards of one device.

The counterpart of ``lbm_tpu``'s ``__graft_entry__.dryrun_multichip`` /
``_dryrun_impl`` / ``_stale_reference`` (:44, :164, :110): 12 steps of a
closed box of 8*P x 128 cells over P shards of the chosen device
(``--host-devices`` semantics: every shard its own tensor), and the
relations ``lbm_tpu`` asserts:

- sync and overlap on the torch backend equal the single-device twin
  bitwise (tot_u within rtol 1e-6), and so does sync on the cuda backend
  (K1-slab; its plain version on the CPU) within ``ulp`` (0 by default);
- int16: sync-i16 within 1e-4 of the f32 run, overlap-i16 equal to
  sync-i16 within ``ulp``;
- ca (:242-351): each engine forced (``LBM_CA_ENGINE`` slab, resident,
  inplace) at K = 2 and 4 equals sync on the cuda backend within ``ulp``
  (tot_u rtol 1e-4), and auto takes the port's policy engine on these
  8-row shards, K7 (``modes.ca_engine_choice``: where K8 would take the
  whole shard and K7's two copies fit too; ``lbm_tpu``'s auto takes its
  in-place engine there); on a box of 16*P rows the in-place engine split in two
  (``LBM_CA_PARTS=2``) equals sync within ``ulp``, and its runner (lbm_tpu's
  parts-carried hook) equals its per-step split bitwise; ca-i16 through the
  slab and the in-place engines stays within 1e-4 of the f32 run;
- async (k = 1, 3) and chunked (k = 2) stay inside the stale-fraction
  envelope (rel deviation < 5 x 4.5e-4 x 2P/ny x age, lbm_tpu's calibration);
- async's and async-k's ghost age is exact: the run equals, bitwise, the
  trajectory rebuilt from its definition (step t consumes the edge rows of
  the state after max(t - 1 - k, 0) steps) with the plain slab step, on
  both backends, and a doubled age gives a different trajectory.

    python -m lbm_tpu_torch.tools.dryrun [--devices 8] [--device cuda|cpu]

Prints one line per relation and exits 0 when all hold; raises otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import warnings

import numpy as np
import torch

STEPS = 12
_DEV_PER_EXPOSURE = 4.5e-4  # lbm_tpu's calibration of this scene (__graft_entry__.py:373)
_SAFETY = 5.0


def toy_scene(ny: int, nx: int, max_iters: int = 100):
    """A closed box with density 0.1, accel 0.005, omega 1.85."""
    from lbm_tpu_torch.io.scene import Scene
    from lbm_tpu_torch.params import LBMParams

    params = LBMParams(nx=nx, ny=ny, max_iters=max_iters, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return Scene(params=params, obstacles=mask)


def run_steps(program, steps: int):
    """``steps`` steps through ``program.step``; (f, tot_us) as numpy."""
    st, tots = program.init_state, []
    for _ in range(steps // program.steps_per_call):
        st, tu = program.step(st)
        tots.append(np.atleast_1d(tu.cpu().numpy().astype(np.float32)))
    f = program.f_of(st).cpu().numpy().astype(np.float32)
    return f, np.concatenate(tots)


def stale_reference(params, obstacles, n_shards: int, staleness: int, steps: int, device):
    """The bounded-staleness trajectory rebuilt from its definition
    (``lbm_tpu``'s ``_stale_reference``): step t consumes the ring images of
    the state after max(t - 1 - staleness, 0) steps, through the plain slab
    step, one shard at a time.  Returns (f, tot_us) as numpy."""
    from lbm_tpu_torch.core import lattice
    from lbm_tpu_torch.ops import fused_torch
    from lbm_tpu_torch.parallel import modes

    ny, nx = obstacles.shape
    nloc = ny // n_shards
    slabs = torch.from_numpy(modes._extended_obstacle_slabs(obstacles, n_shards)).to(device)

    def edges(state):
        lo = [state[:, (r * nloc - 1) % ny][:, None] for r in range(n_shards)]
        hi = [state[:, ((r + 1) * nloc) % ny][:, None] for r in range(n_shards)]
        return lo, hi

    f = torch.from_numpy(lattice.equilibrium_rest(params.density, ny, nx)).to(device)
    hist, tot_us = [edges(f)], []
    for t in range(1, steps + 1):
        glo, ghi = hist[max(t - 1 - staleness, 0)]
        shards, tot = [], 0.0
        for r in range(n_shards):
            slab = torch.cat([glo[r], f[:, r * nloc:(r + 1) * nloc], ghi[r]], dim=1)
            new, tu = fused_torch.fused_step_slab(slab, slabs[r], params, r * nloc)
            shards.append(new)
            tot += float(tu)
        f = torch.cat(shards, dim=1)
        hist.append(edges(f))
        tot_us.append(np.float32(tot))
    return f.cpu().numpy(), np.asarray(tot_us, np.float32)


def _setenv(name: str, value: str | None) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


@contextlib.contextmanager
def env(**values):
    """The environment variables ``values`` set (None: unset) inside the
    block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            _setenv(k, v)
        yield
    finally:
        for k, v in old.items():
            _setenv(k, v)


def dryrun(n_devices: int, device: str = "cuda", ulp: float = 0.0) -> list[str]:
    """Assert every relation on ``n_devices`` shards of ``device``; returns
    the report lines."""
    from lbm_tpu_torch.models import program as single
    from lbm_tpu_torch.parallel import mesh as mesh_lib
    from lbm_tpu_torch.parallel import modes

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_row_mesh(n_devices, mesh_lib.available_devices(dev, n_devices))
    scene = toy_scene(8 * n_devices, 128, STEPS)
    params, obst = scene.params, scene.obstacles
    lines = []

    def report(mode, staleness, storage, relation, d):
        lines.append(f"dryrun ok: mode={mode} staleness={staleness} storage={storage} "
                     f"devices={n_devices} ({dev.type})  {relation} (max|df|={d:.2e})")
        print(lines[-1], flush=True)

    def build(mode, staleness, storage="f32", backend=None, scene=scene):
        with warnings.catch_warnings():
            # The toy shapes trip the stale-fraction warning by design.
            warnings.simplefilter("ignore", UserWarning)
            return modes.build_sharded_program(scene.params, scene.obstacles, mesh, mode=mode,
                                               staleness=staleness, storage=storage,
                                               backend=backend)

    f_ref, tot_ref = run_steps(single.build_single_program(params, obst, dev, backend="torch"),
                               STEPS)

    f_sync, tot_sync = run_steps(build("sync", 1, backend="torch"), STEPS)
    np.testing.assert_array_equal(f_sync, f_ref)
    np.testing.assert_allclose(tot_sync, tot_ref, rtol=1e-6)
    report("sync", 1, "f32", "== single-device (bitwise)", 0.0)

    f_ov, _ = run_steps(build("overlap", 1, backend="torch"), STEPS)
    np.testing.assert_array_equal(f_ov, f_sync)
    report("overlap", 1, "f32", "== sync (bitwise)", 0.0)

    f_syc, tot_syc = run_steps(build("sync", 1, backend="cuda"), STEPS)
    np.testing.assert_allclose(f_syc, f_ref, atol=ulp, rtol=0)
    np.testing.assert_allclose(tot_syc, tot_ref, rtol=1e-5)
    report("sync", 1, "f32", "== single-device (cuda slabs)", float(np.abs(f_syc - f_ref).max()))

    f_si, _ = run_steps(build("sync", 1, "i16"), STEPS)
    assert np.abs(f_si - f_ref).max() < 1e-4, "i16 outside quant envelope"
    report("sync", 1, "i16", "quant envelope vs f32 single-device",
           float(np.abs(f_si - f_ref).max()))
    f_ovi, _ = run_steps(build("overlap", 1, "i16"), STEPS)
    np.testing.assert_allclose(f_ovi, f_si, atol=ulp, rtol=0)
    report("overlap", 1, "i16", "== sync-i16", float(np.abs(f_ovi - f_si).max()))

    for K in (2, 4):
        for engine in modes.CA_ENGINES:
            with env(LBM_CA_ENGINE=engine):
                prog = build("ca", K)
            assert prog.engine == engine, f"ca K={K} ran {prog.engine}, forced {engine}"
            f_ca, tot_ca = run_steps(prog, STEPS)
            np.testing.assert_allclose(f_ca, f_syc, atol=ulp, rtol=0)
            np.testing.assert_allclose(tot_ca, tot_syc, rtol=1e-4)
            report("ca", K, "f32", f"== sync (exact comm-avoiding, {engine} engine)",
                   float(np.abs(f_ca - f_syc).max()))
    auto = build("ca", 4).engine
    assert auto == "resident", f"auto ca engine on 8x128 shards: {auto}"
    report("ca", 4, "f32", "auto takes the resident engine (K7) on 8-row shards", 0.0)

    # The in-place engine split into sub-slabs, on 16-row shards.
    scene_p = toy_scene(16 * n_devices, 128, STEPS)
    f_sp, tot_sp = run_steps(build("sync", 1, backend="cuda", scene=scene_p), STEPS)
    with env(LBM_CA_ENGINE="inplace", LBM_CA_PARTS="2"):
        prog = build("ca", 4, scene=scene_p)
    f_parts, tot_parts = run_steps(prog, STEPS)
    np.testing.assert_allclose(f_parts, f_sp, atol=ulp, rtol=0)
    np.testing.assert_allclose(tot_parts, tot_sp, rtol=1e-4)
    report("ca", 4, "f32", "== sync (inplace engine, parts=2 split sub-slabs)",
           float(np.abs(f_parts - f_sp).max()))
    st, tots = prog.make_run_all(STEPS)(prog.init_state)
    np.testing.assert_array_equal(prog.f_of(st).cpu().numpy(), f_parts)
    np.testing.assert_allclose(tots.cpu().numpy(), tot_parts, rtol=1e-6)
    report("ca", 4, "f32", "runner (parts-carried hook) == per-step split (bitwise)", 0.0)

    for engine, K in (("slab", 2), ("inplace", 4)):
        with env(LBM_CA_ENGINE=engine):
            f_cai, _ = run_steps(build("ca", K, "i16"), STEPS)
        assert np.abs(f_cai - f_ref).max() < 1e-4, f"ca-i16 ({engine}) outside quant envelope"
        report("ca", K, "i16", f"quant envelope vs f32 single-device ({engine} engine)",
               float(np.abs(f_cai - f_ref).max()))

    f_max = float(np.abs(f_ref).max())
    for mode, staleness in (("async", 1), ("async", 3), ("chunked", 2)):
        f_a, tot_a = run_steps(build(mode, staleness), STEPS)
        assert np.isfinite(f_a).all() and np.isfinite(tot_a).all()
        d = float(np.abs(f_a - f_ref).max())
        age = (staleness + 1) / 2 if mode == "chunked" else staleness
        bound = _SAFETY * _DEV_PER_EXPOSURE * (2.0 * n_devices / (8 * n_devices) * age)
        assert d / f_max < bound, (f"{mode} staleness={staleness} deviates {d / f_max:.2e} "
                                   f"from sync, outside the envelope {bound:.2e}")
        report(mode, staleness, "f32",
               f"bounded staleness (rel dev {d / f_max:.2e} < model {bound:.2e})", d)

    for staleness in (1, 3):
        f_exp, tot_exp = stale_reference(params, obst, n_devices, staleness, STEPS, dev)
        for backend in ("torch", "cuda"):
            f_a, tot_a = run_steps(build("async", staleness, backend=backend), STEPS)
            np.testing.assert_allclose(f_a, f_exp, atol=ulp if backend == "cuda" else 0, rtol=0)
            np.testing.assert_allclose(tot_a, tot_exp, rtol=1e-5)
        f_wrong, _ = stale_reference(params, obst, n_devices, 2 * staleness, STEPS, dev)
        assert not np.array_equal(f_a, f_wrong), "age check is vacuous: doubled age matched"
        report("async", staleness, "f32",
               "ghost age exact (== definition reconstruction, torch and cuda slabs)", 0.0)
    return lines


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device", file=sys.stderr)
        return 1
    dryrun(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
