"""K5 (the skewed sweep, ops/skew_cuda.py) against lbm_tpu's skewed pair.

On the CPU the wrapper runs the plain sweep (``fused_torch.run_sweeps``),
held here against ``lbm_tpu.ops.skew_pallas.make_run_all`` in interpret
mode, as tests/test_skew.py runs it, on the same numpy inputs.  A sweep of
the port is K steps; a pair of lbm_tpu's is 2K (a forward sweep that leaves
the state rotated and a reverse one that restores it).  So the step counts
compared split into whole sweeps and a K1 tail on both sides: 2K steps are
two sweeps here and one pair there; 21 steps at K=2 are ten sweeps and a
tail of 1 here, five pairs and a tail of 1 there.

Bounds are those of tests/test_temporal.py:48-49, fields atol 5e-7 and
tot_u rtol 1e-4 (XLA on the CPU contracts multiply-adds to FMAs, torch
does not; ROADMAP queue C).  In int16 a pair quantizes twice, after K and
after 2K steps, as two sweeps of the port do; the 1-ulp f32 noise flips an
int16 at a rounding tie in the first sweep and the flip feeds the second:
at most one quantization step, on under 5% of values (measured: 974 of
36864 at K=4).

Tests marked ``cuda`` hold K5 to its plain version on the card (fields
bitwise, tot_u rtol 1e-6) and skip without one.  As in
test_torch_temporal.py, lbm_tpu is imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import quant, skew_cuda
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams

from test_torch_temporal import _sweep_matches_plain, cuda_device  # noqa: F401

torch.set_num_threads(1)
DENSITY = 0.1


def _scene(ny, nx, seed):
    """tests/test_skew.py's scene: 8% random walls, walled top and bottom."""
    from lbm_tpu.params import LBMParams as JParams

    kw = dict(nx=nx, ny=ny, max_iters=16, reynolds_dim=10, density=DENSITY, accel=0.005,
              omega=1.85)
    mask = np.random.default_rng(seed).random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return LBMParams(**kw), JParams(**kw), mask


@pytest.mark.parametrize(
    "ny,K,steps",
    [(32, 2, 4), (32, 4, 8), (32, 8, 16), (64, 2, 4), (64, 4, 8), (64, 8, 16), (32, 2, 21),
     (16, 4, 8)],
    ids=["32-K2", "32-K4", "32-K8", "64-K2", "64-K4", "64-K8", "32-K2x21-tail",
         "ny16-driven-row-in-wrap"],
)
def test_skew_plain_matches_b6(ny, K, steps):
    import jax.numpy as jnp
    from lbm_tpu.core import lattice as jlattice
    from lbm_tpu.ops import skew_pallas

    params, jparams, mask = _scene(ny, 128, seed=K + ny)
    f0 = jlattice.equilibrium_rest(DENSITY, ny, 128)
    f_j, tot_j = skew_pallas.make_run_all(jparams, mask, steps, K)(jnp.asarray(f0))
    launches = LAUNCHES["K5"]
    f_t, tot_t = skew_cuda.make_run_all(params, torch.from_numpy(mask), steps, K)(
        torch.from_numpy(f0))
    assert LAUNCHES["K5"] == launches  # CPU tensors take the plain version
    assert tot_t.shape == (steps,)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=5e-7)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j, np.float32), rtol=1e-4)


@pytest.mark.parametrize("K", [2, 4])
def test_skew_i16_sweeps_match_b6_pair(K):
    """Two int16 sweeps against one int16 pair, from the same quantized
    (perturbed rest) state: each side quantizes after K and after 2K steps."""
    import jax.numpy as jnp
    from lbm_tpu.core import lattice as jlattice
    from lbm_tpu.ops import skew_pallas

    params, jparams, mask = _scene(32, 128, seed=9)
    rng = np.random.default_rng(11)
    f0 = np.asarray(jlattice.equilibrium_rest(DENSITY, 32, 128))
    f0 = (f0 * (1 + 0.01 * rng.random(f0.shape, dtype=np.float32))).astype(np.float32)
    q0 = quant.quantize(torch.from_numpy(f0), DENSITY)
    q_j, tot_j = skew_pallas.make_run_all(jparams, mask, 2 * K, K, storage="i16")(
        jnp.asarray(q0.numpy()))
    q_t, tot_t = skew_cuda.make_run_all(params, torch.from_numpy(mask), 2 * K, K, "i16")(q0)
    assert q_t.dtype == torch.int16
    d = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert d.max() <= 1, f"max int16 diff {d.max()}"
    assert (d != 0).mean() < 0.05, f"{int((d != 0).sum())} values differ"
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-4)


def test_supports_and_geometry():
    def p(ny, nx):
        return LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=DENSITY,
                         accel=0.01, omega=1.85)

    assert skew_cuda.supports(p(32, 128), 2) and skew_cuda.supports(p(16, 16), 8)
    assert not skew_cuda.supports(p(32, 128), 1)
    assert not skew_cuda.supports(p(15, 40), 8)  # ny < 2K: no room for the warm-up
    assert not skew_cuda.supports(p(40, 15), 8)
    assert skew_cuda.supports(p(5, 100), 2)  # the driven row may lie anywhere
    assert not skew_cuda.supports(p(4096, 4096), 32)  # no strip fits 512 threads
    assert skew_cuda.smem_bytes(2, 300, 64) is None  # 2 x 304 - 6 pairs: beyond 512 threads
    assert skew_cuda.smem_bytes(8, 57, 64) is not None  # 8 x 73 - 72 pairs: one a thread of 512
    assert skew_cuda.smem_bytes(8, 58, 64) is None  # 520 pairs
    for K in (2, 3, 4, 8):
        need = skew_cuda.smem_bytes(K, skew_cuda.strip_width(K), skew_cuda.BAND_MAX)
        assert need is not None and need <= 232448
    with pytest.raises(ValueError, match="cannot map"):
        skew_cuda.make_run_all(p(15, 40), torch.zeros((15, 40), dtype=torch.bool), 8, 8)


@pytest.mark.parametrize("K", [2, 3, 4, 5, 8, 16, 21])
def test_strip_pairs_fill_the_block(K):
    """Every thread but at most K - 1 owns one (level, column) pair, each
    pair of the strip once: a walk step is one round on (nearly) every
    thread, never a round of a few.  Depths to 4 fill three blocks of 256
    per SM in shared memory, deeper ones one block of 512."""
    tw, nt = skew_cuda.strip_width(K), skew_cuda.threads(K)
    pairs = skew_cuda.thread_pairs(K, tw)
    cw = tw + 2 * K
    assert tw >= 1 and len(pairs) == skew_cuda.strip_pairs(K, tw)
    assert nt - K < len(pairs) <= nt
    assert sorted(pairs) == sorted({(lv, c) for lv in range(1, K + 1) for c in range(lv, cw - lv)})
    need = skew_cuda.smem_bytes(K, tw, skew_cuda.BAND_MAX)
    blocks_per_sm = 233472 // (need + 1024)
    assert blocks_per_sm >= (3 if K <= 4 else 1)
    assert skew_cuda.smem_bytes(K, tw + 1, 8) is None or nt == 256  # the widest strip
    if K in (4, 8):  # compiled in as kStrip4 / kStrip8 in csrc/skew.cu
        assert tw == {4: 61, 8: 57}[K]


@pytest.mark.parametrize("bh", [1, 3, 5, 8, 45, skew_cuda.BAND_MAX])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
def test_walk_plan_hazards(K, bh):
    """The kernel's walk (``skew_cuda.walk_plan``), for a band shorter than
    R (K + 1), one that R does not divide, and the tallest: every (level,
    row) in [l, rows - l) is computed exactly once, after the three level
    l-1 rows it pulls were computed (or, level 0, had landed) at an earlier
    step; no ring slot is written (or, level 0, has a copy issued into it)
    while a row it holds is still to be read, in that step or later; level
    K covers exactly the band's rows; the walk takes ``walk_steps``."""
    R = skew_cuda.ROWS_PER_STEP
    plan = skew_cuda.walk_plan(K, bh)
    rows = plan["rows"]
    steps = plan["steps"]
    assert rows == bh + 2 * K and len(steps) == skew_cuda.walk_steps(K, bh)
    done: dict[tuple[int, int], int] = {}  # (level, row) -> step it became readable
    for q, sl in plan["prologue"]:
        assert sl == q % skew_cuda.RING0
    last_read: dict[tuple[int, int], int] = {}
    for s, st in enumerate(steps):
        for lv, q, reads, _ in st["cells"]:
            for rl, rq, _ in reads:
                last_read[(rl, rq)] = max(last_read.get((rl, rq), -1), s)
    holder: dict[tuple[int, int], int] = {}  # (level, slot) -> row held
    for q, sl in plan["prologue"]:
        holder[(0, sl)] = q
    for s, st in enumerate(steps):
        for q, sl in st["copies"]:  # issued at step s: the slot must be dead from now on
            old = holder.get((0, sl))
            assert old is None or last_read.get((0, old), -1) < s, (s, q, old)
            assert sl == q % skew_cuda.RING0
            holder[(0, sl)] = q
        for lv, q, reads, (wl, wq, wsl) in st["cells"]:
            assert (lv, q) not in done, f"({lv}, {q}) computed twice"
            assert lv <= q < rows - lv and len(reads) == 3
            for rl, rq, rsl in reads:
                assert rl == lv - 1 and abs(rq - q) <= 1
                assert done.get((rl, rq), s) < s, f"({lv}, {q}) at step {s} reads ({rl}, {rq})"
                assert holder.get((rl, rsl)) == rq, f"slot {rsl} of level {rl} lost row {rq}"
            if wsl is None:
                assert lv == K
            else:
                old = holder.get((lv, wsl))
                assert old is None or old == q or last_read.get((lv, old), -1) < s
                assert wsl == q % skew_cuda.RING
                holder[(lv, wsl)] = q
        for lv, q, _, _ in st["cells"]:
            done[(lv, q)] = s
        for q in st["landed"]:
            done[(0, q)] = s
        assert len({(lv, q) for lv, q, _, _ in st["cells"]}) == len(st["cells"])
        per_level = {}
        for lv, q, _, _ in st["cells"]:
            per_level.setdefault(lv, []).append(q)
        assert all(len(v) <= R for v in per_level.values())  # R rows a level a step
    for lv in range(1, K + 1):
        assert {q for (l2, q) in done if l2 == lv} == set(range(lv, rows - lv))
    assert {q - K for (l2, q) in done if l2 == K} == set(range(bh))  # the band's rows


def test_band_rows_fill_the_slots():
    """Bands no taller than BAND_MAX; the blocks of the chosen height fill
    their rounds of slots to at least 85% at the policy's grids; a tiny
    grid takes bands of one row; the one-row walk's library keeps its own
    strips and bands."""
    for n in (512, 1024, 1536, 2048, 4096):
        for K, slots in ((2, 396), (4, 396), (8, 132)):
            bh = skew_cuda.band_rows(n, n, K, slots)
            blocks = -(-n // skew_cuda.strip_width(K)) * -(-n // bh)
            assert 1 <= bh <= skew_cuda.BAND_MAX
            assert blocks / (-(-blocks // slots) * slots) >= 0.85, (n, K, bh, blocks)
    assert skew_cuda.band_rows(17, 40, 4, 396) == 1
    assert skew_cuda.geometry(4, 2048, 2048, lib=object()) == skew_cuda.LEGACY_GEOMETRY


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(17, 40), (60, 100), (512, 512)], ids=str)
def test_k5_matches_plain_on_card(cuda_device, shape, K, kind, storage):  # noqa: F811
    _sweep_matches_plain(skew_cuda, cuda_device, shape, K, kind, storage)


# (ny, nx, band rows): bands that R does not divide and bands shorter than
# R (K + 1), nx below one strip, ny = 2K (bands that wrap the grid), odd nx
# (float32 4-byte copies, int16 plain loads) and nx = 2 mod 4 (8- and
# 4-byte copies); together they put the driven row (ny - 2) on the first
# and the last of a walk step's R rows at every level
# (test_hard_shapes_cover_the_walk).
def _hard_shapes(K):
    return [(17, 40, 3), (60, 100, 5), (30, 20, 7), (2 * K, 33, 2 * K), (31, 66, 4),
            (45, 99, 6)]


@pytest.mark.parametrize("K", [2, 3, 4, 8])
def test_hard_shapes_cover_the_walk(K):
    R = skew_cuda.ROWS_PER_STEP
    got = set().union(*(skew_cuda.driven_positions(ny, K, bh)
                       for ny, _, bh in _hard_shapes(K)))
    assert got == {(lv, i) for lv in range(1, K + 1) for i in range(R)}
    for ny, nx, bh in _hard_shapes(K):
        assert bh % R or bh < R * (K + 1) or nx < skew_cuda.strip_width(K) or ny == 2 * K
    copies = {(st, skew_cuda.copy_bytes(nx, st)) for _, nx, _ in _hard_shapes(K)
              for st in ("f32", "i16")}
    assert copies == {("f32", 16), ("f32", 8), ("f32", 4), ("i16", 16), ("i16", 8), ("i16", 4),
                      ("i16", 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("case", range(6), ids=["bh3", "bh5", "narrow", "ny2K", "nx66",
                                                "nx99"])
def test_k5_hard_shapes_on_card(cuda_device, case, K, kind, storage):  # noqa: F811
    ny, nx, bh = _hard_shapes(K)[case]
    _sweep_matches_plain(skew_cuda, cuda_device, (ny, nx), K, kind, storage,
                         strip_band=(skew_cuda.strip_width(K), bh))


@pytest.mark.cuda
def test_k5_geometry_on_card(cuda_device):  # noqa: F811
    """The library's shared memory is the host's; the card holds at least
    one block per SM at every depth (three at K <= 4); a sweep repeats
    bitwise."""
    from lbm_tpu_torch.ops import _build

    lib = _build.load()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for K in (2, 3, 4, 8):
        tw = skew_cuda.strip_width(K)
        for bh in (1, 45, skew_cuda.BAND_MAX):
            assert lib.lbm_skew_smem(K, tw, bh) == skew_cuda.smem_bytes(K, tw, bh)
        assert lib.lbm_skew_grid(K, tw, skew_cuda.BAND_MAX) >= (3 if K <= 4 else 1) * sms
    assert lib.lbm_skew_smem(8, 58, 64) == -1
    params = LBMParams(nx=100, ny=60, max_iters=1, reynolds_dim=10, density=DENSITY,
                       accel=0.005, omega=1.85)
    obst = torch.zeros((60, 100), dtype=torch.bool, device=cuda_device)
    f0 = torch.from_numpy(np.ascontiguousarray(
        np.random.default_rng(3).uniform(0.01, 0.02, (9, 60, 100)).astype(np.float32)
    )).to(cuda_device)
    run = skew_cuda.make_run_all(params, obst, 12, 4)
    f_a, tot_a = (t.clone() for t in run(f0))
    f_b, tot_b = run(f0)
    assert torch.equal(f_a, f_b) and torch.equal(tot_a, tot_b)
