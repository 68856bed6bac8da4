"""lbm_tpu_torch's exact communication-avoiding mode (ca): the plain ca sweep
against lbm_tpu's three engines, the port's ca programs against lbm_tpu's and
against sync, the engine and parts policy, the sync tail, and (marked
``cuda``) K4-slab, K7, K8 and their int16 forms against the plain sweep on
the card.

Against ``lbm_tpu`` on the CPU its Pallas engines run in interpret mode and
XLA contracts multiply-adds into FMAs where torch does not (ROADMAP queue
C): fields agree within atol 2e-7 after a K <= 8 sweep, tot_u within rtol
1e-4; int16 within the per-step tie flips of queue C (a few values one
quantization step apart).  Inside the port the relations are bitwise: every
engine's ca run equals sync, the split in-place engine equals the whole one,
the runner equals the per-step split, K8-i16 equals sync-i16.  lbm_tpu and
jax are imported inside the tests that compare against them, so that the
card, which has no jax, runs the ``cuda`` ones:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ca.py
"""

import os
import warnings

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver
from lbm_tpu_torch.ops import ca_cuda, fused_torch, quant, temporal_cuda
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.parallel import mesh, modes
from lbm_tpu_torch.tools import scenegen

torch.set_num_threads(1)
STEPS = 16


def _params(ny, nx, accel=0.005):
    return LBMParams(nx=nx, ny=ny, max_iters=STEPS, reynolds_dim=10, density=0.1,
                     accel=accel, omega=1.85)


def _scene(ny, nx, seed):
    """tests/test_ca.py's scenes: 8% random walls, walled top and bottom rows."""
    r = np.random.default_rng(seed)
    mask = r.random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return _params(ny, nx), mask, r


def _perturbed(p, r):
    """tests/test_ca.py:518-519: rest times 1 + 1% uniform noise."""
    f = np.asarray(lattice.equilibrium_rest(p.density, p.ny, p.nx), np.float32)
    return f * (np.float32(1.0) + np.float32(0.01) * r.random(f.shape, dtype=np.float32))


def _cut(f_full, mask, off, nloc, K):
    """(lo, body, hi, obst_ext) of the shard at row ``off`` (numpy)."""
    ny = mask.shape[0]
    rows = lambda a, b: np.arange(a, b) % ny  # noqa: E731
    return (f_full[:, rows(off - K, off)], f_full[:, rows(off, off + nloc)],
            f_full[:, rows(off + nloc, off + nloc + K)], mask[rows(off - K, off + nloc + K)])


def _jparams(p):
    from lbm_tpu.params import LBMParams as JParams

    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters, reynolds_dim=p.reynolds_dim,
                   density=p.density, accel=p.accel, omega=p.omega)


# (engine, storage, ny, nloc, K): lbm_tpu's engines where they map (its
# resident and in-place engines need 8-aligned extended slabs, so K = 2 is
# the slab's); offsets put the driven row (ny - 2) in the lower ghosts, the
# body, the upper ghosts and nowhere.
_REF_CASES = [
    ("slab", "f32", 32, 16, 2), ("slab", "f32", 64, 16, 8), ("slab", "f32", 128, 24, 4),
    ("resident", "f32", 32, 16, 4), ("resident", "f32", 128, 24, 8),
    ("inplace", "f32", 32, 16, 4), ("inplace", "f32", 64, 16, 8),
    ("inplace", "f32", 128, 24, 4),
    ("slab", "i16", 32, 16, 4), ("inplace", "i16", 32, 16, 4), ("inplace", "i16", 128, 24, 8),
]


def _offsets(ny, nloc, K):
    """Shard offsets: the driven row in the lower ghosts (0: they wrap to
    the top rows), the body, the upper ghosts, and (for tall grids) none."""
    drive = ny - 2
    return sorted({0, nloc, drive - nloc // 2, drive - nloc, 3 * nloc % ny})


@pytest.mark.parametrize("engine,storage,ny,nloc,K", _REF_CASES, ids=str)
def test_plain_ca_sweep_matches_lbm_tpu_engine(engine, storage, ny, nloc, K):
    """The plain ca sweep (int16 once per sweep for the slab engine, once per
    step for the in-place one) against lbm_tpu's make_slab_sweep,
    make_ca_chunk_runner and make_ca_inplace_runner in interpret mode, on the
    inputs of tests/test_ca.py:486-576."""
    import jax.numpy as jnp

    from lbm_tpu.ops import resident_pallas, temporal_pallas

    nx = 128
    p, mask, r = _scene(ny, nx, 3)
    jp = _jparams(p)
    ref = {"slab": lambda: temporal_pallas.make_slab_sweep(jp, nloc, nx, K, interpret=True,
                                                           storage=storage, ny_global=ny),
           "resident": lambda: resident_pallas.make_ca_chunk_runner(jp, nloc, nx, K,
                                                                    ny_global=ny, interpret=True),
           "inplace": lambda: resident_pallas.make_ca_inplace_runner(
               jp, nloc, nx, K, ny_global=ny, interpret=True, storage=storage)}[engine]()
    quantize = "sweep" if engine == "slab" else "step"
    f_full = _perturbed(p, r)
    if storage == "i16":
        f_full = quant.quantize(torch.from_numpy(f_full), p.density).numpy()
    for off in _offsets(ny, nloc, K):
        lo, body, hi, ob = _cut(f_full, mask, off, nloc, K)
        f_j, tot_j = ref(jnp.asarray(body), jnp.asarray(lo), jnp.asarray(hi),
                         jnp.asarray(ob.astype(np.float32)), off)
        f_p, tot_p = fused_torch.ca_sweep(*(torch.from_numpy(np.ascontiguousarray(x))
                                            for x in (lo, body, hi, ob)),
                                          p, off, ny, storage, quantize)
        f_j, f_p = np.asarray(f_j), f_p.numpy()
        if storage == "f32":
            np.testing.assert_allclose(f_p, f_j, atol=2e-7, rtol=0, err_msg=f"offset {off}")
        else:
            # Tie flips (queue C): a value one quantization step apart where
            # the FMA's ulp lands on a rounding tie.  Once per sweep that
            # happens once (measured: 0.3% of the values, one step; bound 1%);
            # once per step each flip feeds the next steps, as in queue C's
            # free-running case (measured: one step at K = 4, four steps at
            # K = 8 on 11% of the values; bound K/2 steps on 25%).
            d = np.abs(f_p.astype(np.int32) - f_j.astype(np.int32))
            most, share = (1, 1e-2) if quantize == "sweep" else (K // 2, 0.25)
            assert d.max() <= most and np.count_nonzero(d) <= share * d.size, (
                off, d.max(), np.count_nonzero(d))
        # tot_u: rtol 1e-4 (queue C); int16 1e-3, the flipped values' |u|
        # (measured 1.6e-4 at K = 8 once per step).
        np.testing.assert_allclose(tot_p.numpy(), np.asarray(tot_j),
                                   rtol=1e-4 if storage == "f32" else 1e-3,
                                   err_msg=f"offset {off}")


@pytest.mark.parametrize("engine", modes.CA_ENGINES)
def test_ca_program_matches_lbm_tpu(engine, monkeypatch):
    """The port's build_sharded_program(mode="ca") against lbm_tpu's on its
    CPU mesh (tests/conftest.py), each engine forced in both, K = 4 on 8-row
    shards of a 32x128 scene: fields within atol 2e-7 after 16 steps, tot_u
    within rtol 1e-4, and the same label."""
    import jax

    from lbm_tpu.parallel import mesh as jmesh
    from lbm_tpu.parallel import modes as jmodes

    p, mask, _ = _scene(32, 128, 21)
    monkeypatch.setenv("LBM_CA_ENGINE", engine)
    jprog = jmodes.build_sharded_program(_jparams(p), mask, jmesh.make_row_mesh(4), mode="ca",
                                         staleness=4)
    prog = modes.build_sharded_program(p, mask, mesh.make_row_mesh(4, ["cpu"] * 4), "ca", 4)
    assert (prog.engine, prog.variant, prog.steps_per_call) == (jprog.engine, jprog.variant, 4)
    step = jax.jit(jprog.step)
    st, jst, tots, jtots = prog.init_state, jprog.init_state, [], []
    for _ in range(STEPS // 4):
        st, tu = prog.step(st)
        jst, jtu = step(jst)
        tots.append(tu.numpy())
        jtots.append(np.asarray(jtu, np.float32))
    np.testing.assert_allclose(prog.f_of(st).numpy(), np.asarray(jprog.f_of(jst)), atol=2e-7,
                               rtol=0)
    np.testing.assert_allclose(np.concatenate(tots), np.concatenate(jtots), rtol=1e-4)


def _mesh(n):
    return mesh.make_row_mesh(n, ["cpu"] * n)


def _run(prog, steps):
    st, tots = prog.init_state, []
    for _ in range(steps // prog.steps_per_call):
        st, tu = prog.step(st)
        tots.append(np.atleast_1d(tu.numpy()))
    return prog.f_of(st).numpy(), np.concatenate(tots)


@pytest.mark.parametrize("engine,K,storage", [
    ("slab", 2, "f32"), ("slab", 3, "f32"), ("resident", 3, "f32"), ("resident", 4, "f32"),
    ("inplace", 2, "f32"), ("inplace", 3, "f32"), ("slab", 4, "i16"), ("inplace", 3, "i16"),
], ids=str)
def test_ca_equals_sync_inside_the_port(engine, K, storage, monkeypatch):
    """Inside the port ca is sync, bitwise: every engine at K = 2, 3, 4 on a
    40x100 box over 5 shards of 8 rows, an ny the shard count does not
    divide with walled seams (the 3-row pad); K8-i16 equals sync-i16
    bitwise, the slab engine's int16 (once per sweep) stays within 1e-4 of
    f32 sync."""
    p, mask, _ = _scene(37, 100, 9)
    monkeypatch.setenv("LBM_CA_ENGINE", engine)
    ca = modes.build_sharded_program(p, mask, _mesh(5), "ca", K, storage=storage)
    assert ca.engine == engine and ca.variant == f"ca-{K}" + ("-i16" if storage == "i16" else "")
    f_ca, t_ca = _run(ca, 12 if K == 3 else STEPS)
    sync = modes.build_sharded_program(p, mask, _mesh(5), "sync", storage=storage)
    f_s, t_s = _run(sync, 12 if K == 3 else STEPS)
    if storage == "f32" or engine == "inplace":
        np.testing.assert_array_equal(f_ca, f_s)
        np.testing.assert_allclose(t_ca, t_s, rtol=1e-6)
    else:
        f32 = modes.build_sharded_program(p, mask, _mesh(5), "sync")
        assert np.abs(f_ca - _run(f32, STEPS)[0]).max() < 1e-4


def test_ca_split_parts_and_runner_bitwise(monkeypatch):
    """LBM_CA_PARTS=2 on 16-row shards (8-row sub-slabs, K = 4) equals sync
    bitwise; the runner (``make_run_all``, lbm_tpu's parts-carried hook)
    equals the per-step split; an impossible split raises."""
    p, mask, _ = _scene(64, 128, 23)
    monkeypatch.setenv("LBM_CA_ENGINE", "inplace")
    monkeypatch.setenv("LBM_CA_PARTS", "2")
    ca = modes.build_sharded_program(p, mask, _mesh(4), "ca", 4)
    f_ca, t_ca = _run(ca, STEPS)
    st, tots = ca.make_run_all(STEPS)(ca.init_state)
    np.testing.assert_array_equal(ca.f_of(st).numpy(), f_ca)
    np.testing.assert_array_equal(tots.numpy(), t_ca)
    f_s, t_s = _run(modes.build_sharded_program(p, mask, _mesh(4), "sync"), STEPS)
    np.testing.assert_array_equal(f_ca, f_s)
    np.testing.assert_allclose(t_ca, t_s, rtol=1e-6)
    monkeypatch.setenv("LBM_CA_PARTS", "3")
    with pytest.raises(ValueError, match="LBM_CA_PARTS=3"):
        modes.build_sharded_program(p, mask, _mesh(4), "ca", 4)


@pytest.mark.parametrize("n,nx,K,grid", [(256, 1024, 8, 528), (64, 1024, 8, 320),
                                          (8, 100, 8, 10), (13, 128, 3, 14), (24, 99, 8, 19),
                                          (8, 100, 2, 5), (2, 7, 2, 1)], ids=str)
def test_k8_sweep_plan_edges(n, nx, K, grid):
    """K8's band plan (``ca_cuda.sweep_plan``): step t splits the rows still
    exact, [t + 1, ext - t - 1), evenly over every block afresh (the shrinking
    steps leave no block a near-empty share: shares differ by one cell at
    most); step 0 reads only the windows and waits for no block; a later
    step's block waits for the blocks of the step before that hold a cell
    within one row of its own, and for no block outside it."""
    import bisect

    ext = n + 2 * K
    plan = ca_cuda.sweep_plan(ext, nx, K, grid)
    assert len(plan) == K
    for t, step in enumerate(plan):
        cells = [e - s for s, e, _, _ in step]
        assert step[0][0] == (t + 1) * nx and step[-1][1] == (ext - t - 1) * nx
        assert all(step[b][1] == step[b + 1][0] for b in range(grid - 1))
        assert min(cells) >= 1 and max(cells) - min(cells) <= 1
        if t == 0:
            assert all(n_dep == 0 for *_, n_dep in step)
            continue
        starts = [s for s, _, _, _ in plan[t - 1]]
        for s, e, lo, n_dep in step:
            rows = range(s // nx - 1, (e - 1) // nx + 2)
            need = {bisect.bisect_right(starts, x) - 1
                    for r in rows for x in (r * nx, r * nx + nx - 1)}
            assert set(range(lo, lo + n_dep)) == set(range(min(need), max(need) + 1))


def test_k8_partials_sizes():
    """The partials of one K8 launch on the 256x1024 shard at K = 8 over 528
    blocks (and of K9's parts, which share one buffer): the plan (8 x 528 x 4
    words), 528 step counters and 8 x 528 sums; a slab too short to give
    every block a cell of its last step is refused."""
    from lbm_tpu_torch.ops import inplace_cuda

    plan = ca_cuda.sweep_plan(272, 1024, 8, 528)
    buf = inplace_cuda.partials_buffer(plan, 8, "cpu")
    assert buf.numel() == inplace_cuda.partials_words(8, 528, 8) == 8 * 528 * 4 + 528 + 8 * 528
    assert not buf.view(torch.int32)[8 * 528 * 4:].any()
    with pytest.raises(ValueError, match="cannot be split"):
        ca_cuda.sweep_plan(6, 4, 2, 9)


def test_ca_policy_functions(monkeypatch):
    """ca_depth, ca_engine_choice, ca_parts, ca_supported and
    ca_default_staleness against their docstrings."""
    monkeypatch.delenv("LBM_CA_ENGINE", raising=False)
    monkeypatch.delenv("LBM_CA_PARTS", raising=False)
    assert [modes.ca_depth(s) for s in (1, 2, 3, 8)] == [2, 2, 3, 8]
    p = _params(1024, 1024)
    # Auto: where K8 would take the whole extended slab, K7 where its two
    # copies fit too (measured on the card), else K8; else K4-slab (f32);
    # int16 K8-i16 wherever it maps, split or not.
    assert modes.ca_engine_choice(p, 256, 1024, 4) == "resident"
    assert modes.ca_engine_choice(p, 256, 1024, 8) == "resident"
    assert modes.ca_engine_choice(_params(3072, 1024), 768, 1024, 8) == "inplace"  # 2 copies > L2
    assert modes.ca_engine_choice(p, 256, 1024, 8, storage="i16") == "inplace"
    big = _params(4096, 4096)
    assert modes.ca_engine_choice(big, 1024, 4096, 4) == "slab"
    assert modes.ca_engine_choice(big, 1024, 4096, 4, storage="i16") == "inplace"
    assert modes.ca_engine_choice(p, 256, 1024, 4, backend="torch") is None
    assert modes.ca_engine_choice(p, 256, 1024, 4, backend="jnp") is None
    assert modes.ca_engine_choice(p, 1, 1024, 4) is None  # fewer body rows than K
    for engine in modes.CA_ENGINES:
        monkeypatch.setenv("LBM_CA_ENGINE", engine)
        assert modes.ca_engine_choice(p, 256, 1024, 4) == engine
    monkeypatch.setenv("LBM_CA_ENGINE", "resident")
    assert modes.ca_engine_choice(p, 256, 1024, 4, storage="i16") is None  # K7 is f32
    assert modes.ca_engine_choice(_params(4096, 4096), 1024, 4096, 4) is None  # 2 copies > L2
    monkeypatch.setenv("LBM_CA_ENGINE", "inplace")
    assert modes.ca_engine_choice(p, 8, 128, 4, ny_global=11) is None  # ext > ny, split too
    assert modes.ca_engine_choice(p, 8, 128, 4, ny_global=16) == "inplace"
    monkeypatch.setenv("LBM_CA_ENGINE", "bogus")
    with pytest.raises(ValueError, match="LBM_CA_ENGINE"):
        modes.ca_engine_choice(p, 256, 1024, 4)
    monkeypatch.delenv("LBM_CA_ENGINE")
    # Sub-slabs: 1 where the whole extended slab fits 36 MiB, else the
    # smallest split that does; forced splits need only K8's own rules.
    assert ca_cuda.inplace_parts(256, 1024, 8, 1024) == 1
    assert ca_cuda.inplace_parts(1024, 4096, 8, 4096) == 8  # 128-row sub-slabs, ext 144
    assert ca_cuda.inplace_parts(1024, 4096, 8, 4096, "i16") == 4
    assert ca_cuda.inplace_parts(8, 256, 16, 512) is None  # nloc < K
    assert modes.ca_parts(1024, 4096, 8, 4096) == 8
    monkeypatch.setenv("LBM_CA_PARTS", "2")
    assert modes.ca_parts(1024, 4096, 8, 4096) == 2  # forced: leaves L2, still exact
    assert ca_cuda.parts_valid(16, 128, 4, 64, 2) and not ca_cuda.parts_valid(16, 128, 4, 64, 8)
    box = np.zeros((40, 16), dtype=bool)
    box[0] = box[-1] = True
    assert modes.ca_supported(_params(40, 16), box, 4, 4)
    assert not modes.ca_supported(_params(40, 16), box, 4, 12)  # 10-row shards < K
    open_seam = np.zeros((41, 16), dtype=bool)
    assert not modes.ca_supported(_params(41, 16), open_seam, 4, 4)
    # K = 8 where K7 or K8 sweeps the shard unsplit at K = 8, else 4.
    assert modes.ca_default_staleness(p, np.zeros((1024, 1024), bool), 4) == 8
    assert modes.ca_default_staleness(_params(3072, 1024), np.zeros((3072, 1024), bool), 4) == 8
    assert modes.ca_default_staleness(big, np.zeros((4096, 4096), bool), 4) == 4
    assert modes.ca_default_staleness(_params(24, 16), box[:24], 4) == 4  # 6-row shards < 8
    monkeypatch.setenv("LBM_CA_ENGINE", "slab")
    assert modes.ca_default_staleness(p, np.zeros((1024, 1024), bool), 4) == 4
    monkeypatch.setenv("LBM_CA_ENGINE", "resident")
    assert modes.ca_default_staleness(p, np.zeros((1024, 1024), bool), 4) == 8
    monkeypatch.delenv("LBM_CA_ENGINE")
    with pytest.raises(ValueError, match="open-seam"):
        modes.build_sharded_program(_params(41, 16), open_seam, _mesh(4), "ca", 4)
    with pytest.raises(ValueError, match="cuda backend"):
        modes.build_sharded_program(_params(40, 16), box, _mesh(4), "ca", 4, backend="torch")
    with pytest.raises(ValueError, match="K-sweep engine"):
        modes.build_sharded_program(_params(40, 16), box, _mesh(4), "ca", 12)


def test_ca_sync_tail_label_and_continuation():
    """10 steps at K = 4: two sweeps and a 2-step sync tail on the same
    mesh, ``ca-4+sync-tail2``, bitwise equal to a sync run; 3 steps are the
    tail alone."""
    p, mask, _ = _scene(32, 128, 21)
    scene = Scene(params=p, obstacles=mask)

    def run(variant, steps, **kw):
        return driver.run_simulation(scene, driver.RunConfig(
            variant=variant, device="cpu", host_devices=4, num_steps=steps, **kw))

    for steps, label in ((10, "ca-4+sync-tail2"), (3, "ca-4+sync-tail3"), (8, "ca-4")):
        res, sync = run("ca", steps, staleness=4), run("sync", steps)
        assert res.variant == label
        np.testing.assert_array_equal(res.f, sync.f)
        np.testing.assert_allclose(res.av_vels, sync.av_vels, rtol=1e-6)


def test_auto_takes_lbm_tpu_rule_on_shards():
    """auto on more than one device: ca wherever it maps, at the default
    depth, else the stale-row rule; with --staleness the depth asked."""
    dev = torch.device("cpu")
    p, mask, _ = _scene(32, 128, 21)
    scene = Scene(params=p, obstacles=mask)
    assert driver.choose_variant(scene, driver.RunConfig(device="cpu", host_devices=4),
                                 dev) == "ca"
    res = driver.run_simulation(scene, driver.RunConfig(device="cpu", host_devices=4,
                                                        num_steps=8))
    assert res.variant == "ca-8"  # 8-row shards: K8 sweeps them unsplit at K = 8
    cfg = driver.RunConfig(device="cpu", host_devices=4, staleness=12)  # 8-row shards < K
    assert driver.choose_variant(scene, cfg, dev) == "overlap"


def test_cli_ca_run_matches_sync(tmp_path, capsys):
    """``run --variant ca --host-devices 4 --staleness 3`` reports ca-3 and
    writes sync's final_state.dat byte for byte."""
    params = _params(32, 64).replace(max_iters=9)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    outs = {}
    for variant in ("ca", "sync"):
        out = tmp_path / variant
        assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", variant,
                         "--host-devices", "4", "--staleness", "3", "--out-dir", str(out)]) == 0
        outs[variant] = out
    assert "Variant:\t\t\tca-3\n" in capsys.readouterr().out
    assert ((outs["ca"] / "final_state.dat").read_bytes()
            == (outs["sync"] / "final_state.dat").read_bytes())


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_slab(n, nx, K, where, start, device, storage, seed=0):
    """(params, lo, body, hi, obst_ext, row_offset) of an n-row shard of a
    grid of max(64, 4n) rows, cut from a seeded field: walls on the edge
    columns and every seventh cell of a middle column; ``where`` puts the
    driven row in the body, the lower or upper ghosts, or nowhere."""
    ny = max(64, 4 * n)
    p = _params(ny, nx, accel=0.01)
    off = {"body": p.accel_row - n // 2, "lo": p.accel_row + 1 + (K - 1) // 2,
           "hi": p.accel_row - n - K // 2, "none": K}[where] % ny
    f = lattice.equilibrium_rest(p.density, n + 2 * K, nx)
    if start == "mixed":
        rng = np.random.default_rng(seed + n + nx + K)
        f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
        w1, _ = lattice.accel_weights(p.density, p.accel)
        f[3, :, ::3] = w1 * np.float32(0.5)
    m = np.zeros((n + 2 * K, nx), dtype=bool)
    m[:, 0] = m[:, -1] = True
    m[::7, nx // 2] = True
    x = torch.from_numpy(f).to(device)
    if storage == "i16":
        x = quant.quantize(x, p.density)
    return (p, x[:, :K].clone(), x[:, K:K + n].contiguous(), x[:, K + n:].clone(),
            torch.from_numpy(m).to(device), off)


_KERNELS = {  # name -> (bind, plain, storage)
    "K4-slab": (temporal_cuda.bind_slab_sweep, temporal_cuda.slab_plain, "f32"),
    "K4-slab-i16": (temporal_cuda.bind_slab_sweep, temporal_cuda.slab_plain, "i16"),
    "K7": (ca_cuda.bind_resident, ca_cuda.sweep_plain, "f32"),
    "K8": (ca_cuda.bind_inplace, ca_cuda.sweep_plain, "f32"),
    "K8-i16": (ca_cuda.bind_inplace, ca_cuda.sweep_plain, "i16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(_KERNELS))
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(8, 100), (13, 128), (40, 256)], ids=str)
def test_ca_kernel_matches_plain_on_card(cuda_device, kernel, K, shape):
    """Each ca engine against the plain sweep: fields (int16 too) equal,
    tot_u within rtol 1e-6, the driven row in the body, either ghost region
    and none, from rest and perturbed; the launch counts."""
    bind, plain, storage = _KERNELS[kernel]
    n, nx = shape
    if n < K:
        pytest.skip("fewer body rows than K")
    for where in ("body", "lo", "hi", "none"):
        for start in ("rest", "mixed"):
            p, lo, body, hi, ob, off = _card_slab(n, nx, K, where, start, cuda_device, storage)
            extra = {} if kernel == "K7" else {"storage": storage}
            out = torch.zeros_like(body)
            tots = torch.zeros(K + 1, dtype=torch.float32, device=cuda_device)
            bind(p, lo, body, hi, ob, out, tots, off, p.ny, **extra)(1)
            ref, ref_tot = plain(lo, body, hi, ob, p, off, p.ny, storage)
            assert torch.equal(out, ref), (where, start,
                                           float((out.double() - ref.double()).abs().max()))
            torch.testing.assert_close(tots[1:], ref_tot, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3, 8])
def test_k7_bands_shorter_than_a_row_on_card(cuda_device, K):
    """K7 on an 8x2048 shard: its grid splits every step's rows into bands
    shorter than a row (its plan checked so), the driven row in the body,
    either ghost region and none: fields equal the plain sweep, tot_u
    within rtol 1e-6."""
    from lbm_tpu_torch.ops import _build

    n, nx = 8, 2048
    ext = n + 2 * K
    grid = ca_cuda.resident_grid(_build.load().lbm_ca_resident_grid(ext, nx, cuda_device.index),
                                 n, nx)
    plan = ca_cuda.resident_plan(ext, nx, K, grid)
    assert all(max(e - s for s, e, _, _ in step) < nx for step in plan)
    for where in ("body", "lo", "hi", "none"):
        p, lo, body, hi, ob, off = _card_slab(n, nx, K, where, "mixed", cuda_device, "f32")
        out = torch.zeros_like(body)
        tots = torch.zeros(K, dtype=torch.float32, device=cuda_device)
        ca_cuda.bind_resident(p, lo, body, hi, ob, out, tots, off, p.ny)(0)
        ref, ref_tot = ca_cuda.sweep_plain(lo, body, hi, ob, p, off, p.ny)
        assert torch.equal(out, ref), where
        torch.testing.assert_close(tots, ref_tot, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_k7_repeats_bitwise_on_card(cuda_device):
    """Two K7 launches of one binding from the same shard give the same
    body and per-level sums, bit for bit (the step counters run on from
    launch to launch)."""
    p, lo, body, hi, ob, off = _card_slab(40, 256, 8, "body", "mixed", cuda_device, "f32")
    out = torch.zeros_like(body)
    tots = torch.zeros(16, dtype=torch.float32, device=cuda_device)
    launch = ca_cuda.bind_resident(p, lo, body, hi, ob, out, tots, off, p.ny)
    launch(0)
    first = out.clone()
    launch(8)
    assert torch.equal(out, first) and torch.equal(tots[:8], tots[8:])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_ca_programs_equal_sync_on_card(cuda_device, storage, monkeypatch):
    """Every engine's ca program on 4 shards of the card (K = 2, 3 and 4,
    the in-place engine also split in 2) equals sync on fields, bitwise
    (the slab engine's int16, once per sweep, equals the plain sweep's run
    instead: K4-slab-i16 on the CPU); the runner repeats bitwise."""
    p, mask, _ = _scene(64, 100, 5)
    msh = mesh.make_row_mesh(4, [cuda_device] * 4)
    sync = modes.build_sharded_program(p, mask, msh, "sync", storage=storage)
    st, t_s = sync.make_run_all(12)(sync.init_state)
    f_s = sync.f_of(st).cpu()
    for engine, K, parts in (("slab", 2, ""), ("slab", 3, ""), ("resident", 4, ""),
                             ("inplace", 3, ""), ("inplace", 4, "2")):
        if storage == "i16" and engine == "resident":
            continue
        monkeypatch.setenv("LBM_CA_ENGINE", engine)
        monkeypatch.setenv("LBM_CA_PARTS", parts)
        ca = modes.build_sharded_program(p, mask, msh, "ca", K, storage=storage)
        run = ca.make_run_all(12)
        st, t_c = run(ca.init_state)
        f_c = ca.f_of(st).cpu()
        if storage == "i16" and engine == "slab":
            cpu = modes.build_sharded_program(p, mask, _mesh(4), "ca", K, storage=storage)
            ref = cpu.f_of(cpu.make_run_all(12)(cpu.init_state)[0])
            assert torch.equal(f_c, ref), engine
        else:
            assert torch.equal(f_c, f_s), (engine, K, parts)
            torch.testing.assert_close(t_c, t_s, rtol=1e-6, atol=0.0)
        st2, t_c2 = run(ca.init_state)
        assert torch.equal(ca.f_of(st2).cpu(), f_c) and torch.equal(t_c2, t_c)
