"""lbm_tpu_torch's sharded disciplines (parallel/modes.py) against lbm_tpu's
and against themselves, on shards of the CPU (``--host-devices`` semantics:
every shard its own tensor).

Against ``lbm_tpu`` (its 8 virtual CPU devices, tests/conftest.py): XLA on
the CPU contracts multiply-adds into FMAs and torch does not (ROADMAP queue
C), so fields agree within atol 5e-8 after one step (one chunk for
chunked) and 2e-7 after 25, av within rtol 1e-4; the int16 slab step
within one quantization step at a few rounding ties.  Inside the port the
relations are bitwise: sync equals the single-device twin, overlap equals
sync, async's ghost age equals its definition, chunked's step equals k
inner steps and an exchange.  Tests marked ``cuda`` hold K1-slab and the
sharded runs against their plain versions on the card and skip without one;
lbm_tpu and jax are imported inside the tests that compare against them, so
that the card, which has no jax, runs the ``cuda`` ones:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel.py
"""

import warnings

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.models.variants import resolve_variant
from lbm_tpu_torch.ops import fused_cuda, fused_torch, ghosted_cuda, quant
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.parallel import mesh, modes
from lbm_tpu_torch.tools import dryrun, pod, scenegen

torch.set_num_threads(1)
STEPS = 25


def _params(ny, nx, accel=0.005):
    return LBMParams(nx=nx, ny=ny, max_iters=STEPS, reynolds_dim=10, density=0.1,
                     accel=accel, omega=1.85)


def _jparams(p):
    from lbm_tpu.params import LBMParams as JParams

    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters, reynolds_dim=p.reynolds_dim,
                   density=p.density, accel=p.accel, omega=p.omega)


def _box(ny, nx):
    """The small_obstacles fixture's closed box with an interior block."""
    m = np.zeros((ny, nx), dtype=bool)
    m[0, :] = m[-1, :] = True
    m[:, 0] = m[:, -1] = True
    m[5:7, 8:10] = True
    return m


def _open(ny, nx=16):
    """An open periodic seam: only an interior block."""
    m = np.zeros((ny, nx), dtype=bool)
    m[5:7, 8:10] = True
    return m


def _mesh(n):
    return mesh.make_row_mesh(n, ["cpu"] * n)


def _build(p, m, shards, mode, k=1, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the stale-fraction warning
        return modes.build_sharded_program(p, m, _mesh(shards), mode, k, **kw)


def _run(prog, steps):
    """Through step(): (f after the first call, f, tot_us) as numpy."""
    st, tots, first = prog.init_state, [], None
    for _ in range(steps // prog.steps_per_call):
        st, tu = prog.step(st)
        tots.append(np.atleast_1d(tu.numpy()))
        if first is None:
            first = prog.f_of(st).numpy().copy()
    return first, prog.f_of(st).numpy(), np.concatenate(tots)


def _jrun(prog, steps):
    import jax

    step = jax.jit(prog.step)
    st, tots, first = prog.init_state, [], None
    for _ in range(steps // prog.steps_per_call):
        st, tu = step(st)
        tots.append(np.atleast_1d(np.asarray(tu, np.float32)))
        if first is None:
            first = np.asarray(prog.f_of(st))
    return first, np.asarray(prog.f_of(st)), np.concatenate(tots)


def _single(p, m, steps=STEPS):
    prog = program.build_single_program(p, m, "cpu")
    f, tots = prog.make_run_all(steps)(prog.init_state)
    return f.numpy(), tots.numpy()


# --- against lbm_tpu ---------------------------------------------------------


@pytest.mark.parametrize("mode,k,shards", [
    ("sync", 1, 2), ("sync", 1, 8), ("overlap", 1, 2), ("overlap", 1, 8), ("async", 1, 2),
    ("async", 3, 2), ("async", 2, 4), ("chunked", 2, 2), ("chunked", 3, 2),
], ids=lambda v: str(v))
def test_discipline_matches_lbm_tpu(mode, k, shards):
    """Each discipline against lbm_tpu's build_sharded_program(backend="jnp")
    on the 16x16 box (``async`` with k = 2 is async-k's default)."""
    from lbm_tpu.parallel import mesh as jmesh
    from lbm_tpu.parallel import modes as jmodes

    p, m = _params(16, 16), _box(16, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jprog = jmodes.build_sharded_program(_jparams(p), m, jmesh.make_row_mesh(shards),
                                             mode=mode, staleness=k, backend="jnp")
    steps = STEPS - STEPS % k if mode == "chunked" else STEPS
    j1, jf, jt = _jrun(jprog, steps)
    t1, tf, tt = _run(_build(p, m, shards, mode, k, backend="torch"), steps)
    np.testing.assert_allclose(t1, j1, atol=5e-8, rtol=0)
    np.testing.assert_allclose(tf, jf, atol=2e-7, rtol=0)
    np.testing.assert_allclose(tt, jt, rtol=1e-4)


@pytest.mark.parametrize("seam", ["open", "walled"])
@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("ny,shards", [(16, 3), (18, 5), (19, 4)])
def test_indivisible_grid_seams(mode, ny, shards, seam):
    """Seam padding on indivisible grids, open (live clone rows) and walled
    (blocked rows): bitwise equal to the single-device twin inside the port,
    and within the FMA tolerance of lbm_tpu's jnp run."""
    from lbm_tpu.parallel import mesh as jmesh
    from lbm_tpu.parallel import modes as jmodes

    p, m = _params(ny, 16), (_open(ny) if seam == "open" else _box(ny, 16))
    assert bool(modes.open_seam_pad(m, shards)) == (seam == "open")
    t1, tf, tt = _run(_build(p, m, shards, mode, backend="torch"), 24)
    sf, st = _single(p, m, 24)
    assert tf.shape == (9, ny, 16)
    np.testing.assert_array_equal(tf, sf)
    np.testing.assert_allclose(tt, st, rtol=1e-6)
    jprog = jmodes.build_sharded_program(_jparams(p), m, jmesh.make_row_mesh(shards),
                                         mode=mode, backend="jnp")
    j1, jf, jt = _jrun(jprog, 24)
    np.testing.assert_allclose(t1, j1, atol=5e-8, rtol=0)
    np.testing.assert_allclose(tf, jf, atol=2e-7, rtol=0)
    np.testing.assert_allclose(tt, jt, rtol=1e-4)


@pytest.mark.parametrize("where", ["body", "lo", "hi", "none"])
def test_slab_step_matches_fused_step_slab(where):
    """The plain slab step against lbm_tpu's fused_step_slab, one step from
    a seeded perturbed slab, the driven row in the body, a ghost or none."""
    import jax.numpy as jnp

    from lbm_tpu.ops import fused_jnp

    p = _params(64, 24)
    n = 6
    rng = np.random.default_rng(3)
    slab = lattice.equilibrium_rest(p.density, n + 2, p.nx) * (
        np.float32(1) + rng.uniform(-0.1, 0.1, (9, n + 2, p.nx)).astype(np.float32))
    slab[3, :, ::3] = lattice.accel_weights(p.density, p.accel)[0] * np.float32(0.5)
    ob = rng.random((n + 2, p.nx)) < 0.2
    off = {"body": p.accel_row - 2, "lo": p.accel_row + 1, "hi": p.accel_row - n,
           "none": 0}[where]
    f, tot = fused_torch.fused_step_slab(torch.from_numpy(slab), torch.from_numpy(ob), p, off)
    jf, jtot = fused_jnp.fused_step_slab(jnp.asarray(slab), jnp.asarray(ob), _jparams(p), off)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=5e-8, rtol=0)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-6)
    # The slab step of a whole periodic grid's rows is the full-grid step.
    g, gm = torch.from_numpy(slab[:, 1:-1]), torch.from_numpy(ob[1:-1])
    wrapped = torch.cat([g[:, -1:], g, g[:, :1]], dim=1)
    wm = torch.cat([gm[-1:], gm, gm[:1]])
    q = p.replace(ny=n)
    ref = fused_torch.fused_step_single(g, gm, q)
    assert torch.equal(fused_torch.fused_step_slab(wrapped, wm, q, 0).f, ref.f)


@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("where", ["body", "lo", "hi"])
def test_slab_kernel_plain_matches_pallas_slab_step(storage, where):
    """K1-slab's plain version (make_slab_step on CPU tensors) against
    lbm_tpu's make_slab_step(interpret=True), one step of an 8 x 128 shard.
    int16: at most one quantization step apart, at a few rounding ties
    (queue C: XLA's FMA in the dequantize)."""
    import jax.numpy as jnp

    from lbm_tpu.ops import fused_pallas

    p = _params(64, 128)
    n = 8
    rng = np.random.default_rng(5)
    slab = lattice.equilibrium_rest(p.density, n + 2, p.nx) * (
        np.float32(1) + rng.uniform(-0.1, 0.1, (9, n + 2, p.nx)).astype(np.float32))
    slab[3, :, ::3] = lattice.accel_weights(p.density, p.accel)[0] * np.float32(0.5)
    ob = np.zeros((n + 2, p.nx), dtype=bool)
    ob[:, 0] = ob[:, -1] = True
    ob[::3, 40] = True
    off = {"body": p.accel_row - 3, "lo": p.accel_row + 1, "hi": p.accel_row - n}[where]
    x = torch.from_numpy(slab)
    if storage == "i16":
        x = quant.quantize(x, p.density)
    f, tot = fused_cuda.make_slab_step(p, storage)(x, torch.from_numpy(ob), off)
    jstep = fused_pallas.make_slab_step(_jparams(p), n, p.nx, interpret=True, storage=storage)
    jf, jtot = jstep(jnp.asarray(x.numpy()), jnp.asarray(ob), off)
    jf = np.asarray(jf)
    if storage == "i16":
        d = np.abs(f.numpy().astype(np.int32) - jf.astype(np.int32))
        assert d.max() <= 1 and np.count_nonzero(d) <= 0.002 * d.size
    else:
        np.testing.assert_allclose(f.numpy(), jf, atol=5e-8, rtol=0)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-5)


# --- inside the port, bitwise ------------------------------------------------


@pytest.mark.parametrize("shards,backend", [(2, "torch"), (4, "cuda"), (8, "cuda"),
                                            (3, "torch")])
def test_sync_equals_single_device(shards, backend):
    """16 rows over 2, 4, 8 shards and (walled seam) 3."""
    p, m = _params(16, 16), _box(16, 16)
    _, f, tots = _run(_build(p, m, shards, "sync", backend=backend), STEPS)
    sf, st = _single(p, m)
    np.testing.assert_array_equal(f, sf)
    np.testing.assert_allclose(tots, st, rtol=1e-6)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_overlap_equals_sync(shards, storage):
    """8 shards of 16 rows are two-row shards: no interior sub-slab."""
    p, m = _params(16, 16), _box(16, 16)
    _, fo, to = _run(_build(p, m, shards, "overlap", storage=storage), STEPS)
    _, fs, ts = _run(_build(p, m, shards, "sync", storage=storage), STEPS)
    np.testing.assert_array_equal(fo, fs)
    np.testing.assert_allclose(to, ts, rtol=1e-6)


def test_sync_i16_equals_single_device_i16():
    p, m = _params(16, 16), _box(16, 16)
    _, f, _ = _run(_build(p, m, 4, "sync", storage="i16"), STEPS)
    prog = program.build_single_program(p, m, "cpu", backend="cuda", storage="i16",
                                        temporal_k=1)
    q, _ = prog.make_run_all(STEPS)(prog.init_state)
    np.testing.assert_array_equal(f, prog.f_of(q).numpy())


@pytest.mark.parametrize("k,backend", [(1, "torch"), (2, "cuda"), (3, "torch")])
def test_async_ghost_age_exact(k, backend):
    """The run equals the trajectory rebuilt from its definition (step t
    consumes the edge rows of the state after max(t - 1 - k, 0) steps),
    bitwise, and not the one of a doubled age."""
    scene = dryrun.toy_scene(16, 16, STEPS)
    _, f, tots = _run(_build(scene.params, scene.obstacles, 2, "async", k, backend=backend),
                      STEPS)
    fe, te = dryrun.stale_reference(scene.params, scene.obstacles, 2, k, STEPS, "cpu")
    np.testing.assert_array_equal(f, fe)
    np.testing.assert_allclose(tots, te, rtol=1e-5)
    fw, _ = dryrun.stale_reference(scene.params, scene.obstacles, 2, 2 * k, STEPS, "cpu")
    assert not np.array_equal(f, fw)


@pytest.mark.parametrize("open_seam", [False, True])
def test_chunked_step_is_inner_steps_and_an_exchange(open_seam):
    ny, k = 16, 3
    p = _params(ny, 16)
    m = _open(ny) if open_seam else _box(ny, 16)
    prog = _build(p, m, 3, "chunked", k)
    st_whole = prog.init_state
    for _ in range(2):
        st_whole, _ = prog.step(st_whole)
    st = prog.init_state
    for _ in range(2):
        for _ in range(k):
            st, _ = prog.chunk_inner_step(st)
        st = prog.chunk_exchange(st)
    assert torch.equal(prog.f_of(st), prog.f_of(st_whole))


def test_chunked_tail_equals_the_primitives():
    """A 2-chunk + 2-step run through the driver equals the same steps taken
    through the program's primitives; its variant names the tail."""
    p, m = _params(16, 16), _box(16, 16)
    scene = Scene(params=p.replace(max_iters=8), obstacles=m)
    res = driver.run_simulation(scene, driver.RunConfig(
        variant="chunked", device="cpu", num_devices=2, staleness=3, host_devices=2))
    assert res.variant == "chunked-3+sync-tail2" and len(res.av_vels) == 8
    prog = _build(p, m, 2, "chunked", 3, backend="torch")
    st, tots = prog.init_state, []
    for _ in range(2):
        st, tu = prog.step(st)
        tots.extend(tu.tolist())
    for _ in range(2):
        st = prog.chunk_exchange(st)
        st, tu = prog.chunk_inner_step(st)
        tots.append(float(tu))
    np.testing.assert_array_equal(res.f, prog.f_of(st).numpy())
    np.testing.assert_array_equal(res.av_vels,
                                  np.asarray(tots, np.float32) / np.float32(prog.tot_cells))


@pytest.mark.parametrize("mode,k", [("async", 2), ("chunked", 2), ("overlap", 1)])
def test_two_runs_are_equal(mode, k):
    p, m = _params(16, 16), _box(16, 16)
    a = _run(_build(p, m, 4, mode, k), 24)
    b = _run(_build(p, m, 4, mode, k), 24)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("variant", ["sync", "async-k", "chunked"])
def test_segmented_run_equals_unsegmented(variant):
    p, m = _params(16, 16), _box(16, 16)
    scene = Scene(params=p.replace(max_iters=24), obstacles=m)
    runs = [driver.run_simulation(scene, driver.RunConfig(
        variant=variant, device="cpu", host_devices=2, segment_steps=seg)) for seg in (0, 8)]
    np.testing.assert_array_equal(runs[0].f, runs[1].f)
    np.testing.assert_array_equal(runs[0].av_vels, runs[1].av_vels)
    assert runs[0].variant == {"sync": "sync", "async-k": "async-2",
                               "chunked": "chunked-2"}[variant]


def test_dryrun_relations_hold_on_cpu_shards():
    lines = dryrun.dryrun(4, "cpu")
    assert len(lines) == 21 and all(ln.startswith("dryrun ok:") for ln in lines)


# --- policy, errors and the CLI ------------------------------------------------


def test_variants_and_ca():
    assert resolve_variant("mpi") == "sync" and resolve_variant("waitall") == "overlap"
    assert resolve_variant("testall") == "async" and resolve_variant("stale") == "async"
    assert resolve_variant("testall-complex") == "async-k"
    assert resolve_variant("semi-async") == "overlap" and resolve_variant("chunked") == "chunked"
    assert resolve_variant("ca") == "ca"
    p, m = _params(16, 16), _box(16, 16)
    prog = modes.build_sharded_program(p, m, _mesh(2), "ca", 4)
    assert (prog.variant, prog.steps_per_call, prog.engine) == ("ca-4", 4, "resident")


def test_auto_picks_lbm_tpu_rule_or_refuses_ca():
    """On more than one device auto follows lbm_tpu: ca where it maps (here
    a closed box); where ca cannot map (an open seam, the torch backend)
    the stale-row rule picks async or overlap."""
    dev = torch.device("cpu")
    box = Scene(params=_params(16, 16), obstacles=_box(16, 16))
    assert driver.choose_variant(box, driver.RunConfig(device="cpu", host_devices=4),
                                 dev) == "ca"
    assert driver.choose_variant(box, driver.RunConfig(device="cpu", host_devices=4,
                                                       backend="torch"), dev) == "overlap"
    tall = Scene(params=_params(401, 16), obstacles=_open(401))  # open seam, padded
    assert driver.choose_variant(tall, driver.RunConfig(device="cpu", num_devices=4,
                                                        host_devices=4), dev) == "async"
    assert driver.choose_variant(box, driver.RunConfig(device="cpu"), dev) == "torch"
    # A host with four cards and no shards asked for: auto shards over all
    # of them, as lbm_tpu does; --devices 1 keeps one card.
    four_cards = [torch.device("cuda", i) for i in range(4)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "available_devices", lambda *a, **k: four_cards)
        cuda0 = torch.device("cuda", 0)
        assert driver.choose_variant(box, driver.RunConfig(), cuda0) == "ca"
        assert driver.choose_variant(box, driver.RunConfig(num_devices=1), cuda0) == "cuda"
    with pytest.raises(ValueError, match="requested 3 devices but only 2 available"):
        driver.run_simulation(box, driver.RunConfig(variant="sync", device="cpu",
                                                    num_devices=3, host_devices=2))
    with pytest.raises(ValueError, match="at least 2 rows per shard"):
        modes.build_sharded_program(box.params, box.obstacles, _mesh(16), "sync")
    with pytest.raises(ValueError, match="requires the cuda backend"):
        modes.build_sharded_program(box.params, box.obstacles, _mesh(2), "sync",
                                    backend="torch", storage="i16")
    with pytest.raises(ValueError, match="fewer devices"):
        modes.build_sharded_program(_params(16, 16), _open(16), _mesh(5), "sync")


def test_mesh_and_ring():
    assert mesh.ring_perms(3) == ([(0, 1), (1, 2), (2, 0)], [(0, 2), (1, 0), (2, 1)])
    assert mesh.available_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.make_row_mesh(2, ["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="requested 5 devices"):
        mesh.make_row_mesh(5, ["cpu"] * 4)


def test_cli_sharded_flags_reach_the_run(tmp_path, capsys, monkeypatch):
    """--devices, --staleness, --backend and --host-devices parse and reach
    RunConfig; a sharded CLI run writes files that pass check against the
    single-device run."""
    params = LBMParams(nx=24, ny=16, max_iters=12, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    seen = []
    real = driver.run_simulation
    monkeypatch.setattr(driver, "run_simulation",
                        lambda scene, config: seen.append(config) or real(scene, config))
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "chunked",
                     "--devices", "2", "--staleness", "4", "--backend", "torch",
                     "--host-devices", "4", "--out-dir", str(tmp_path / "c")]) == 0
    cfg = seen[-1]
    assert (cfg.num_devices, cfg.staleness, cfg.backend, cfg.host_devices) == (2, 4, "torch", 4)
    assert "chunked-4" in capsys.readouterr().out
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "sync",
                     "--host-devices", "2", "--out-dir", str(tmp_path / "s")]) == 0
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--out-dir",
                     str(tmp_path / "t")]) == 0
    capsys.readouterr()
    assert (tmp_path / "s" / "final_state.dat").read_bytes() == \
        (tmp_path / "t" / "final_state.dat").read_bytes()
    assert cli.main(["bench", "--grid", "16x16", "--steps", "4", "--repeats", "1", "--device",
                     "cpu", "--variant", "overlap", "--host-devices", "2"]) == 0
    assert '"variant": "overlap"' in capsys.readouterr().out


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("sync", 1), ("overlap", 1), ("async", 1), ("async", 2),
                                    ("chunked", 2), ("chunked", 3)])
@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_sharded_kernels_match_plain_on_card(cuda_device, mode, k, storage):
    """Every discipline on 4 shards of the card, through K1-slab (and K6 for
    chunked f32), against the same program on 4 shards of the CPU, where
    the wrappers run their plain versions: fields bitwise, tot_u within
    rtol 1e-6."""
    p, m = _params(60, 100), _box(60, 100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        kern = modes.build_sharded_program(p, m, mesh.make_row_mesh(4, [cuda_device] * 4),
                                           mode, k, storage=storage, backend="cuda")
    counts = (fused_cuda.SLAB_LAUNCHES + fused_cuda.SLAB_LAUNCHES_I16, ghosted_cuda.LAUNCHES)
    st, tots = kern.make_run_all(12)(kern.init_state)
    f = kern.f_of(st).cpu()
    k6 = mode == "chunked" and storage == "f32"
    assert ghosted_cuda.LAUNCHES > counts[1] if k6 else (
        fused_cuda.SLAB_LAUNCHES + fused_cuda.SLAB_LAUNCHES_I16 > counts[0])
    twin = _build(p, m, 4, mode, k, storage=storage, backend="cuda")
    st2, tots2 = twin.make_run_all(12)(twin.init_state)
    assert torch.equal(f, twin.f_of(st2))
    torch.testing.assert_close(tots.cpu(), tots2, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,storage", [("sync", 1, "f32"), ("overlap", 1, "f32"),
                                            ("async", 2, "f32"), ("chunked", 2, "f32"),
                                            ("sync", 1, "i16"), ("ca", 4, "f32"),
                                            ("ca", 8, "i16")])
def test_shards_on_separate_cards_match_one_card(cuda_device, mode, k, storage):
    """On a host with four cards, shard r on card r (ghosts copied card to
    card) gives the fields and sums of the same program on four shards of
    one card, bitwise."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    p, m = _params(64, 100), _box(64, 100)
    cards = [torch.device("cuda", i) for i in range(4)]
    runs = []
    for devices in (cards, [cuda_device] * 4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prog = modes.build_sharded_program(p, m, mesh.make_row_mesh(4, devices), mode, k,
                                               storage=storage, backend="cuda")
        st, tots = prog.make_run_all(24)(prog.init_state)
        assert [x.device for x in st.f] == devices
        runs.append((prog.f_of(st).cpu(), tots.cpu()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,storage", [("sync", 1, "f32"), ("overlap", 1, "f32"),
                                            ("async", 2, "f32"), ("chunked", 2, "f32"),
                                            ("sync", 1, "i16"), ("ca", 4, "f32"),
                                            ("ca", 8, "i16")])
def test_nccl_processes_on_separate_cards_match_one_card(cuda_device, tmp_path, mode, k,
                                                         storage):
    """On a host with four cards, four processes (tools/pod.py), one shard
    and one card each, NCCL between them: every rank's gathered fields and
    sums equal one process's over four shards of one card, bitwise
    (tools/dist_smoke.py)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    logs = [str(tmp_path / f"log{r}.txt") for r in range(4)]
    rc = pod.launch(4, ["-m", "lbm_tpu_torch.tools.dist_smoke", "--device", "cuda",
                        "--local-devices", "1", "--mode", mode, "--staleness", str(k),
                        "--storage", storage, "--steps", "24"], timeout=240, logs=logs)
    outs = [open(x).read() for x in logs]
    assert rc == 0, "".join(outs)
    for r, text in enumerate(outs):
        assert f"DIST_SMOKE_OK process={r}/4 devices=4 mode={mode}" in text, text
        assert "backend=nccl" in text


@pytest.mark.cuda
def test_auto_shards_over_the_cards(cuda_device):
    """On a host with four cards a plain ``auto`` run shards over all of
    them, as lbm_tpu does: ca here, whose fields equal the one-card run's
    bitwise."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    scene = Scene(params=_params(64, 100), obstacles=_box(64, 100))
    res = driver.run_simulation(scene, driver.RunConfig(num_steps=24))
    one = driver.run_simulation(scene, driver.RunConfig(num_steps=24, num_devices=1))
    assert res.variant == "ca-8" and one.variant.startswith("cuda-")
    assert np.array_equal(res.f, one.f)
    np.testing.assert_allclose(res.av_vels, one.av_vels, rtol=1e-6)
