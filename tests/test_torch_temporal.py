"""K4 (the trapezoid sweep, ops/temporal_cuda.py), the temporal policy and
the temporal path through the program, driver and CLI, against lbm_tpu.

On the CPU the wrappers run the plain sweep (``fused_torch.run_sweeps``),
held here against ``lbm_tpu.ops.temporal_pallas.make_run_all`` in interpret
mode, as tests/test_temporal.py runs it, on the same numpy inputs.  Bounds
are those of tests/test_temporal.py:48-49, fields atol 5e-7 and tot_u rtol
1e-4: XLA on the CPU contracts multiply-adds to FMAs and torch does not
(ROADMAP queue C).  For int16 one sweep starts both sides from the same
quantized state; the 1-ulp f32 noise flips an int16 at a rounding tie: at
most one quantization step on under 1% of values.

Tests marked ``cuda`` hold K4 to its plain version on the card (fields
bitwise, tot_u rtol 1e-6) and skip without one.  lbm_tpu (and so jax) is
imported inside the tests that compare against it, so that the card-only
tests also run where jax is not installed.
"""

import warnings

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.ops import (
    fused_cuda,
    fused_torch,
    hbm_cuda,
    inplace_cuda,
    quant,
    resident_cuda,
    skew_cuda,
    temporal_cuda,
)
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import scenegen

torch.set_num_threads(1)
DENSITY = 0.1


def _scene(ny, nx, seed):
    """tests/test_temporal.py's scene: 8% random walls, walled top and bottom."""
    from lbm_tpu.params import LBMParams as JParams

    kw = dict(nx=nx, ny=ny, max_iters=12, reynolds_dim=10, density=DENSITY, accel=0.005,
              omega=1.85)
    mask = np.random.default_rng(seed).random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return LBMParams(**kw), JParams(**kw), mask


def _compare(got, want):
    (f_t, tot_t), (f_j, tot_j) = got, want
    assert tot_t.shape == np.asarray(tot_j).shape
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=5e-7)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j, np.float32), rtol=1e-4)


@pytest.mark.parametrize(
    "ny,K,steps",
    [(32, 2, 8), (32, 3, 9), (32, 4, 8), (32, 4, 7), (16, 4, 8)],
    ids=["K2x8", "K3x9", "K4x8", "K4x7-remainder", "ny16-driven-row-in-wrap"],
)
def test_trapezoid_plain_matches_b5(ny, K, steps):
    """32x128 at (K, steps) in {(2,8), (3,9), (4,8)}; 7 steps at K=4 (one
    sweep and a K1 tail of 3 on both sides); ny=16 at K=4, where the driven
    row (14) lies in the rows that wrap past the top."""
    import jax.numpy as jnp
    from lbm_tpu.core import lattice as jlattice
    from lbm_tpu.ops import temporal_pallas

    params, jparams, mask = _scene(ny, 128, seed=K + ny)
    f0 = jlattice.equilibrium_rest(DENSITY, ny, 128)
    want = temporal_pallas.make_run_all(jparams, mask, steps, K)(jnp.asarray(f0))
    launches = LAUNCHES["K4"]
    got = temporal_cuda.make_run_all(params, torch.from_numpy(mask), steps, K)(
        torch.from_numpy(f0))
    assert LAUNCHES["K4"] == launches  # CPU tensors take the plain version
    _compare(got, want)


@pytest.mark.parametrize("K", [2, 4])
def test_trapezoid_i16_sweep_matches_b5(K):
    """One int16 sweep from the same quantized (perturbed rest) state: B5
    dequantizes once, keeps K float32 levels and quantizes once; so does
    the plain sweep.  Measured: at most 120 of 36864 values differ, by one."""
    import jax.numpy as jnp
    from lbm_tpu.core import lattice as jlattice
    from lbm_tpu.ops import temporal_pallas

    params, jparams, mask = _scene(32, 128, seed=9)
    rng = np.random.default_rng(11)
    f0 = np.asarray(jlattice.equilibrium_rest(DENSITY, 32, 128))
    f0 = (f0 * (1 + 0.01 * rng.random(f0.shape, dtype=np.float32))).astype(np.float32)
    q0 = quant.quantize(torch.from_numpy(f0), DENSITY)
    q_j, tot_j = temporal_pallas.make_run_all(jparams, mask, K, K, storage="i16")(
        jnp.asarray(q0.numpy()))
    q_t, tot_t = temporal_cuda.make_sweep(params, torch.from_numpy(mask), K, "i16")(q0)
    assert q_t.dtype == torch.int16 and tot_t.shape == (K,)
    d = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert d.max() <= 1, f"max int16 diff {d.max()}"
    assert (d != 0).mean() < 0.01, f"{int((d != 0).sum())} values differ"
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-4)


def test_plain_sweep_is_k_steps_and_one_quantization():
    """The plain sweep: f32 is bitwise K twin steps; int16 decodes once,
    steps K times in f32 and encodes once, unlike K steps of the int16 step."""
    params, _, mask = _scene(16, 24, seed=1)
    obst = torch.from_numpy(mask)
    f0 = lattice.equilibrium_rest_device(DENSITY, 16, 24, "cpu")
    f, tot = fused_torch.sweep(f0, obst, params, 3)
    f_s, tot_s = fused_torch.run_steps(f0, obst, params, 3)
    assert torch.equal(f, f_s) and torch.equal(tot, tot_s)
    q0 = quant.quantize(f_s, DENSITY)
    q, tot = fused_torch.sweep(q0, obst, params, 3, "i16")
    f3, tot3 = fused_torch.run_steps(quant.dequantize(q0, DENSITY), obst, params, 3)
    assert torch.equal(q, quant.quantize(f3, DENSITY)) and torch.equal(tot, tot3)
    f, tot = fused_torch.run_sweeps(q0, obst, params, 7, 3, "i16")
    q2, t2 = fused_torch.sweep(fused_torch.sweep(q0, obst, params, 3, "i16")[0], obst,
                               params, 3, "i16")
    q_tail, t_tail = fused_torch.fused_step_i16(q2, obst, params)
    assert torch.equal(f, q_tail) and tot.shape == (7,) and tot[6] == t_tail


def _p(n, nx=None):
    return LBMParams(nx=nx or n, ny=n, max_iters=1, reynolds_dim=10, density=DENSITY,
                     accel=0.01, omega=1.85)


def test_supports():
    assert temporal_cuda.supports(_p(32, 128), 2) and temporal_cuda.supports(_p(17, 40), 8)
    assert not temporal_cuda.supports(_p(32, 128), 1)  # K < 2 is not temporal
    assert not temporal_cuda.supports(_p(15, 40), 8)  # ny < 2K
    assert not temporal_cuda.supports(_p(40, 15), 8)  # nx < 2K
    assert temporal_cuda.supports(_p(5, 100), 2)  # no accel_row >= K rule
    assert not temporal_cuda.supports(_p(4096), 24)  # no tile left at this depth
    th, tw = temporal_cuda.tile(4)
    assert temporal_cuda.smem_bytes(4, th, tw) <= temporal_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="cannot map"):
        temporal_cuda.make_run_all(_p(15, 40), torch.zeros((15, 40), dtype=torch.bool), 8, 8)


@pytest.mark.parametrize("nrows,nx,K,grid", [
    (2048, 2048, 4, 132), (1000, 1499, 2, 132), (17, 40, 8, 132), (60, 100, 3, 4),
    (8, 100, 4, None)])
def test_tile_order_and_partials_index(nrows, nx, K, grid):
    """The persistent blocks walk the tiles in a fixed order: block b takes
    tiles b, b + grid, ...; every tile once, its |u| partial at its row-major
    index, whatever the grid (a tile count that is not a multiple of it, or
    fewer tiles than blocks)."""
    th, tw = temporal_cuda.tile(K)
    order = temporal_cuda.tile_order(nrows, nx, K, grid=grid)
    ntx, nty = -(-nx // tw), -(-nrows // th)
    assert len(order) == min(grid or ntx * nty, ntx * nty)
    flat = sorted(t for blk in order for t in blk)
    assert [t for t, _, _ in flat] == list(range(ntx * nty))
    assert all((y0, x0) == ((t // ntx) * th, (t % ntx) * tw) for t, y0, x0 in flat)
    for b, blk in enumerate(order):
        assert [t for t, _, _ in blk] == list(range(b, ntx * nty, len(order)))
    assert all(0 <= y0 < nrows and 0 <= x0 < nx for t, y0, x0 in flat)


def test_region_table_and_shared_memory():
    """Every compiled region: two float32 copies of the region (the level
    buffers, one of which takes the next tile's copy during the last level)
    plus the |u| sums and walls stay within one block's 227 KB
    at every depth it maps, and two blocks of 512 threads of the small
    region fit one SM (228 KB, 1 KB reserved per block); the table's regions
    are compiled ones."""
    for (rh, rw), threads in temporal_cuda.REGIONS.items():
        assert rh <= 64 and rw % 4 == 0 and threads % 32 == 0
        for K in range(2, (min(rh, rw) - 1) // 2 + 1):
            th, tw = rh - 2 * K, rw - 2 * K
            need = temporal_cuda.smem_bytes(K, th, tw)
            assert need >= 2 * 9 * rh * rw * 4
            assert need <= temporal_cuda.SMEM_LIMIT, (rh, rw, K, need)
    rh, rw = temporal_cuda.region(4)
    assert temporal_cuda.REGIONS[(rh, rw)] == 512
    assert 2 * (temporal_cuda.smem_bytes(4, rh - 8, rw - 8) + 1024) <= 233472
    for K in range(2, 9):
        assert temporal_cuda.region(K) in temporal_cuda.REGIONS
        th, tw = temporal_cuda.tile(K)
        assert (th + 2 * K, tw + 2 * K) == temporal_cuda.region(K)


@pytest.mark.parametrize("storage,nx,K,x0,address,want", [
    ("f32", 2048, 4, 0, 0, "elements"),          # wraps at the left edge
    ("f32", 2048, 4, 2016, 0, "elements"),       # wraps at the right edge
    ("f32", 100, 4, 60, 0, "elements"),          # the last tile column wraps
    ("f32", 2048, 4, 32, 4 * 2048, "quads"),     # x0 - K = 28: 112 bytes
    ("f32", 2048, 2, 44, 0, "floats"),           # x0 - K = 42: 168 bytes
    ("f32", 1499, 4, 32, 1499 * 4, "floats"),    # odd nx: row 1 off the 16-byte grid
    ("f32", 1499, 4, 32, 4 * 1499 * 4, "quads"),  # ... row 4 on it
    ("i16", 2048, 4, 32, 0, "loads"),
    ("i16", 1499, 4, 0, 1499 * 2, "loads"),      # int16 takes plain loads, even wrapping
])
def test_copy_path(storage, nx, K, x0, address, want):
    """How a region row comes in (issue_tile, load_i16 in csrc/temporal.cu)."""
    tw = temporal_cuda.tile(K)[1]
    assert temporal_cuda.copy_path(storage, nx, K, x0, tw, address) == want


def test_supports_edges():
    """K4 maps K >= 2 with a tile of at least one cell; ny and nx at least
    2K; K4-slab at least K body rows and any width."""
    rh, rw = temporal_cuda.region(8)
    kmax = (min(rh, rw) - 1) // 2
    assert temporal_cuda.supports(_p(256), kmax) and not temporal_cuda.supports(_p(256), kmax + 1)
    assert temporal_cuda.supports(_p(8, 8), 4) and not temporal_cuda.supports(_p(7, 8), 4)
    assert not temporal_cuda.supports(_p(8, 7), 4)
    assert temporal_cuda.supports_shard(4, 1, 4) and not temporal_cuda.supports_shard(3, 100, 4)
    assert not temporal_cuda.supports_shard(100, 100, 1)
    assert temporal_cuda.supports_shard(100, 100, kmax)
    assert not temporal_cuda.supports_shard(100, 100, kmax + 1)


def test_load_variant_builds_from_replaced_sources(tmp_path, monkeypatch):
    """``_build.load_variant`` (kernel_times --variant) builds the package's
    sources with one file replaced, in a directory of its own keyed by the
    replacement; without nvcc it raises rather than load the package's own
    library."""
    import shutil

    from lbm_tpu_torch.ops import _build

    other = tmp_path / "temporal.cu"
    other.write_text("// another version of the sweep kernel\n")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_variant({"temporal.cu": other})
    (src,) = (tmp_path / "build").glob("src-*")
    assert {f.name for f in _build.sources(src)} == {f.name for f in _build.sources()}
    assert (src / "temporal.cu").read_text() == other.read_text()
    assert (src / "step.cu").read_bytes() == (_build.CSRC / "step.cu").read_bytes()
    assert _build.build_dir(src) != _build.build_dir()


def test_pick_k_and_impl_choice(monkeypatch):
    """The depth and kernel the policy picks (PERF.md §5: K5 for f32 at
    K = 4 from 1024^2 cells, K4 for int16 and other depths), and the
    overrides: LBM_TEMPORAL_K, LBM_TEMPORAL_IMPL=trapezoid|skew|hbm; a
    forced hbm that cannot map raises rather than run another kernel."""
    monkeypatch.delenv("LBM_TEMPORAL_K", raising=False)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL", raising=False)
    for n in (1024, 1536, 2048, 4096):
        assert temporal_cuda.pick_k(_p(n)) == 4
        assert temporal_cuda.pick_k(_p(n), "i16") == 1  # int16 is not swept by default
        assert program.temporal_impl_choice(_p(n), 4) == "skew"
        assert program.temporal_impl_choice(_p(n), 4, "i16") == "trapezoid"
        for K in (2, 8):
            assert program.temporal_impl_choice(_p(n), K) == "trapezoid"
    assert program.temporal_impl_choice(_p(768), 4) == "trapezoid"  # below 1024^2 cells
    assert program.temporal_impl_choice(_p(512, 2048), 4) == "skew"  # counted in cells
    assert temporal_cuda.pick_k(_p(768)) == 1
    assert temporal_cuda.pick_k(_p(512, 2048)) == 4  # counted in cells
    assert temporal_cuda.tile(4) == (24, 40) and temporal_cuda.tile(8) == (32, 48)
    monkeypatch.setenv("LBM_TEMPORAL_K", "8")
    assert temporal_cuda.pick_k(_p(2048)) == 8
    assert temporal_cuda.pick_k(_p(2048), "i16") == 8
    assert temporal_cuda.pick_k(_p(64)) == 8
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "skew")
    assert program.temporal_impl_choice(_p(2048), 4) == "skew"
    assert program.temporal_impl_choice(_p(6), 4) is None  # forced, cannot map
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "trapezoid")
    assert program.temporal_impl_choice(_p(2048), 4, "i16") == "trapezoid"
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "hbm")
    assert program.temporal_impl_choice(_p(2048), 4) == "hbm"
    with pytest.raises(ValueError, match="cannot map"):
        program.temporal_impl_choice(_p(2048), 4, "i16")
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "bogus")
    with pytest.raises(ValueError, match="LBM_TEMPORAL_IMPL"):
        program.temporal_impl_choice(_p(2048), 4)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL")
    assert program.temporal_impl_choice(_p(3), 2) is None  # neither maps


@pytest.mark.parametrize("storage,table", [
    ("f32", {128: "cuda-resident", 256: "cuda-resident", 512: "cuda-resident",
             768: "cuda-resident", 1024: "cuda-inplace", 1536: "cuda-skew",
             2048: "cuda-skew", 4096: "cuda-skew"}),
    ("i16", {128: "cuda-inplace-i16", 256: "cuda-inplace-i16", 512: "cuda-inplace-i16",
             768: "cuda-inplace-i16", 1024: "cuda-inplace-i16", 1536: "cuda-step-i16",
             2048: "cuda-step-i16", 4096: "cuda-step-i16"}),
])
def test_default_policy_table(monkeypatch, storage, table):
    """The kernel the cuda backend runs by default at each square grid of
    the H100 table (PERF.md §5): the fastest one timed in turns there (f32
    sweeps at K = 4 on K5), but for 1024^2 f32, which lbm_tpu's order keeps
    on the in-place kernel, and int16 from 1024^2, which stays on K1-i16
    (quantized every step) because K4-i16 strayed beyond 1% of f32 there.
    Forced depths opt out of K3, never out of K2, and reach the int16
    sweeps (K4-i16)."""
    monkeypatch.delenv("LBM_TEMPORAL_K", raising=False)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL", raising=False)
    got = {n: program.cuda_choice(_p(n), storage)[0] for n in table}
    assert got == table
    assert program.cuda_choice(_p(2048), storage)[1] == (4 if storage == "f32" else 1)
    sfx = "-i16" if storage == "i16" else ""
    sweep4 = "cuda-skew" if storage == "f32" else "cuda-trapezoid-i16"
    assert program.cuda_choice(_p(2048), storage, 4) == (sweep4, 4)
    assert program.cuda_choice(_p(1024), storage, 4) == (sweep4, 4)
    assert program.cuda_choice(_p(1024), storage, 2) == ("cuda-trapezoid" + sfx, 2)
    assert program.cuda_choice(_p(2048), storage, 1) == ("cuda-step" + sfx, 1)
    if storage == "f32":
        assert program.cuda_choice(_p(512), storage, 4) == ("cuda-resident", 1)


def _build(mask, params, storage="f32", **kw):
    return program.build_single_program(params, mask, torch.device("cpu"), backend="cuda",
                                        storage=storage, **kw)


def test_dispatch_order(monkeypatch):
    """modes.py:493-543's order: K2 ignores temporal_k; K3 only without it;
    else the sweeps; ``--temporal-k 1`` gives the K1 loop; a forced depth
    that cannot map warns and gives the K1 loop."""
    monkeypatch.delenv("LBM_TEMPORAL_K", raising=False)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL", raising=False)
    params, _, mask = _scene(16, 24, seed=2)
    assert _build(mask, params, temporal_k=4).variant == "cuda-resident"
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    assert _build(mask, params).variant == "cuda-inplace"
    assert _build(mask, params, "i16").variant == "cuda-inplace-i16"
    prog = _build(mask, params, temporal_k=4)
    assert prog.variant == "cuda-trapezoid" and prog.sweep_k == 4
    assert _build(mask, params, "i16", temporal_k=2).variant == "cuda-trapezoid-i16"
    assert _build(mask, params, temporal_k=1).variant == "cuda-step"
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "skew")
    assert _build(mask, params, temporal_k=2).variant == "cuda-skew"
    monkeypatch.delenv("LBM_TEMPORAL_IMPL")
    with pytest.warns(UserWarning, match="cannot map the temporal sweep"):
        prog = _build(mask, params, temporal_k=9)  # ny 16 < 2K
    assert prog.variant == "cuda-step" and prog.sweep_k == 1
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 0)
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET_I16", 0)
    assert _build(mask, params).variant == "cuda-step"  # auto: pick_k, too small to sweep
    monkeypatch.setattr(temporal_cuda, "SWEEP_MIN_CELLS", 0)
    assert _build(mask, params).variant == "cuda-trapezoid"
    assert _build(mask, params, "i16").variant == "cuda-step-i16"  # int16: never by default
    monkeypatch.setenv("LBM_TEMPORAL_K", "2")
    assert _build(mask, params, "i16").variant == "cuda-trapezoid-i16"
    monkeypatch.setenv("LBM_TEMPORAL_K", "1")
    assert _build(mask, params).variant == "cuda-step"
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "hbm")
    monkeypatch.delenv("LBM_TEMPORAL_K")
    monkeypatch.setattr(hbm_cuda, "L2_SLOTS_BUDGET", 0)
    with pytest.raises(ValueError, match="cannot map"):  # K9's slots fit no budget of 0
        _build(mask, params)
    monkeypatch.setattr(hbm_cuda, "L2_SLOTS_BUDGET", 2**20)
    assert _build(mask, params, temporal_k=4).variant == "cuda-hbm"
    with pytest.raises(ValueError, match="cannot map"):
        _build(mask, params, temporal_k=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert program.build_single_program(params, mask, "cpu", temporal_k=4).variant == "torch"


def test_temporal_runs_equal_k1_runs_and_segment(monkeypatch):
    """Through the driver: the temporal path (sweeps and a K1 tail) equals
    the K1 loop on fields and tot_u, and segmented runs are bitwise equal to
    unsegmented ones (cf. tests/test_temporal.py:169), int16 too: a segment
    is whole sweeps (6 steps round down to one sweep of 4), and only the
    last one has the K1 tail (22 = 5 x 4 + 2)."""
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    scene = Scene(*_scene(24, 40, seed=4)[::2])
    cfg = dict(variant="cuda", device="cpu", num_steps=22)
    base = driver.run_simulation(scene, driver.RunConfig(temporal_k=1, **cfg))
    assert base.variant == "cuda-step"
    for storage in ("f32", "i16"):
        whole = driver.run_simulation(scene, driver.RunConfig(
            temporal_k=4, segment_steps=0, storage=storage, **cfg))
        parts = driver.run_simulation(scene, driver.RunConfig(
            temporal_k=4, segment_steps=6, storage=storage, **cfg))
        assert whole.variant == "cuda-trapezoid" + ("-i16" if storage == "i16" else "")
        assert driver._segment_lengths(22, driver.RunConfig(segment_steps=6), 4) == [4] * 5 + [2]
        np.testing.assert_array_equal(parts.f, whole.f)
        np.testing.assert_array_equal(parts.av_vels, whole.av_vels)
    whole = driver.run_simulation(scene, driver.RunConfig(temporal_k=4, **cfg))
    np.testing.assert_array_equal(whole.f, base.f)
    np.testing.assert_array_equal(whole.av_vels, base.av_vels)


def test_cli_temporal_k_passes_check_against_lbm_tpu(tmp_path, capsys, monkeypatch):
    """``run --device cpu --temporal-k 2`` on a scenegen scene too large for
    the L2 budgets (set to 0 here) runs the sweeps, and its files pass
    lbm_tpu's ``check`` against ``lbm_tpu run --variant jnp``."""
    from lbm_tpu.cli import main as jmain

    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 0)
    params = LBMParams(nx=64, ny=32, max_iters=30, reynolds_dim=10, density=DENSITY,
                       accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "cuda",
                     "--temporal-k", "2", "--out-dir", str(tmp_path / "t")]) == 0
    assert "Variant:\t\t\tcuda-trapezoid" in capsys.readouterr().out
    assert jmain(["run", pfile, ofile, "--variant", "jnp", "--out-dir", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    rc = jmain([
        "check",
        "--ref-av-vels-file", str(tmp_path / "j" / "av_vels.dat"),
        "--ref-final-state-file", str(tmp_path / "j" / "final_state.dat"),
        "--av-vels-file", str(tmp_path / "t" / "av_vels.dat"),
        "--final-state-file", str(tmp_path / "t" / "final_state.dat"),
    ])
    assert rc == 0 and "Both tests passed!" in capsys.readouterr().out


def test_cli_temporal_impl_hbm_exits_1(tmp_path, capsys, monkeypatch):
    """A forced hbm sweep that cannot map (K = 8 on 16 rows: no part of at
    least K rows leaves its slab within the grid) exits 1; it never runs
    another kernel in its place."""
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "hbm")
    params = LBMParams(nx=24, ny=16, max_iters=8, reynolds_dim=10, density=DENSITY,
                       accel=0.005, omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    out = tmp_path / "out"
    rc = cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "cuda",
                   "--temporal-k", "8", "--out-dir", str(out)])
    err = capsys.readouterr().err
    assert rc == 1 and err.startswith("Error:") and "cannot map" in err
    assert not out.exists()


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _box(ny, nx):
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10, density=DENSITY,
                       accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[ny // 3: ny // 3 + 3, nx // 4: nx // 4 + 4] = True
    mask[ny - 2, nx // 2] = True  # a wall on the driven row
    return params, mask


def _start(params, kind, device, storage):
    """``rest``, or the perturbed state of chip_smoke.py: a seeded 10%
    perturbation of rest with the driven row's injection guard false at
    every third cell."""
    f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    if kind == "mixed":
        rng = np.random.default_rng(11)
        f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
        w1, _ = lattice.accel_weights(params.density, params.accel)
        f[3, params.accel_row, ::3] = w1 * np.float32(0.5)
    f = torch.from_numpy(f).to(device)
    return quant.quantize(f, params.density) if storage == "i16" else f


def _sweep_matches_plain(mod, device, shape, K, kind, storage, **kw):
    params, mask = _box(*shape)
    obst = torch.from_numpy(mask).to(device)
    s0 = _start(params, kind, device, storage)
    steps = 2 * K + 1  # two sweeps and a K1 tail step
    sfx = "-i16" if storage == "i16" else ""
    kernel = ("K4" if mod is temporal_cuda else "K5") + sfx
    before, k1 = LAUNCHES[kernel], LAUNCHES["K1" + sfx]
    f_k, tot_k = mod.make_run_all(params, obst, steps, K, storage, **kw)(s0)
    assert LAUNCHES[kernel] == before + 2 and LAUNCHES["K1" + sfx] == k1 + 1
    f_p, tot_p = mod.run_plain(s0, obst, params, steps, K, storage)
    assert f_k.dtype == s0.dtype
    assert torch.equal(f_k, f_p), float((f_k.double() - f_p.double()).abs().max())
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(17, 40), (60, 100)], ids=str)
def test_k4_matches_plain_on_card(cuda_device, shape, K, kind, storage):
    _sweep_matches_plain(temporal_cuda, cuda_device, shape, K, kind, storage)


@pytest.mark.cuda
def test_k4_geometry_and_refusal_on_card(cuda_device):
    """The host's shared-memory arithmetic is the library's; a tile whose
    region has no compiled kernel raises at launch; a sweep repeats bitwise;
    the persistent grid is at most one block per tile."""
    from lbm_tpu_torch.ops import _build

    lib = _build.load()
    for K in (2, 4, 8):
        th, tw = temporal_cuda.tile(K)
        assert lib.lbm_trapezoid_smem(K, th, tw) == temporal_cuda.smem_bytes(K, th, tw)
        strip = (skew_cuda.strip_width(K), skew_cuda.BAND_MAX)
        assert lib.lbm_skew_smem(K, *strip) == skew_cuda.smem_bytes(K, *strip)
    params, mask = _box(60, 100)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _start(params, "mixed", cuda_device, "f32")
    with pytest.raises(RuntimeError, match=r"K4 \(lbm_trapezoid_run\) failed"):
        temporal_cuda.make_run_all(params, obst, 8, 8, tile_hw=(100, 100))(f0)
    assert temporal_cuda.persistent_grid(4, 3) == 3
    assert temporal_cuda.persistent_grid(4, 1 << 20) >= torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    run = temporal_cuda.make_run_all(params, obst, 12, 4)
    f_a, tot_a = (t.clone() for t in run(f0))
    f_b, tot_b = run(f0)
    assert torch.equal(f_a, f_b) and torch.equal(tot_a, tot_b)
    with pytest.raises(ValueError):
        run(f0.cpu())
    with pytest.raises(ValueError):
        run(f0.double())
