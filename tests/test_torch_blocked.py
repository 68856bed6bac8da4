"""K10 (the port of lbm_tpu's B4, ``resident_pallas._blocked_chunk_kernel``),
its plain version and the row-reduced |u| op, and the ``LBM_RESIDENT_KIND``
route to it.

Against ``lbm_tpu`` on the CPU its Pallas kernel runs in interpret mode and
XLA contracts multiply-adds into FMAs where torch does not (ROADMAP queue
C): fields within atol 5e-8 and tot_u within rtol 1e-5, the bounds
tests/test_pallas.py:174-191 holds ``lbm_tpu``'s own kernel to.  Inside the
port the relations are bitwise.  ``lbm_tpu`` is imported inside the tests
that compare against it, so that the card, which has no jax, runs the
``cuda`` ones:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_blocked.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.ops import blocked_cuda, fused_torch, stencil_math
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams, with_driven_row

torch.set_num_threads(1)


def _scene(ny, nx):
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[ny // 3: ny // 3 + 3, nx // 4: nx // 4 + 4] = True
    mask[ny - 2, nx // 2] = True  # a wall on the driven row
    mask[5, 7] = True  # and one on the row that first-block cases drive
    return params, mask


def _mixed(params, seed=3):
    """The rest state with a seeded 10% perturbation and the driven row's
    injection guard false at every third cell."""
    rng = np.random.default_rng(seed)
    f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
    w1, _ = lattice.accel_weights(params.density, params.accel)
    f[3, params.accel_row, ::3] = w1 * np.float32(0.5)
    return f


@pytest.mark.parametrize("masked", [False, True], ids=["all rows", "row mask"])
def test_collide_and_av_rows_matches_lbm_tpu(masked):
    import jax.numpy as jnp

    from lbm_tpu.ops import stencil_math as jstencil

    rng = np.random.default_rng(17)
    rows, nx = 12, 40
    rest = lattice.equilibrium_rest(0.1, rows, nx)
    planes = rest * (np.float32(1.0) + rng.uniform(-0.1, 0.1, rest.shape).astype(np.float32))
    obst = rng.random((rows, nx)) < 0.2
    row_mask = (np.arange(rows) % 3 != 0)[:, None] if masked else None
    omega = float(np.float32(1.85))
    out, vec = stencil_math.collide_and_av_rows(
        list(torch.from_numpy(planes)), torch.from_numpy(obst), omega,
        None if row_mask is None else torch.from_numpy(row_mask))
    j_out, j_vec = jstencil.collide_and_av_rows(
        list(jnp.asarray(planes)), jnp.asarray(obst), jnp.float32(omega),
        None if row_mask is None else jnp.asarray(row_mask))
    assert vec.shape == (1, nx) and j_vec.shape == (1, nx)
    np.testing.assert_allclose(torch.stack(out).numpy(), np.stack(j_out), atol=5e-8)
    np.testing.assert_allclose(vec.numpy(), np.asarray(j_vec), rtol=1e-6)
    # The partial is the rows added in row order, and its sum is
    # collide_and_av's up to the order of the additions.
    _, tot = stencil_math.collide_and_av(list(torch.from_numpy(planes)),
                                         torch.from_numpy(obst), omega)
    if not masked:
        torch.testing.assert_close(fused_torch.column_sum(vec), tot, rtol=1e-6, atol=0.0)


def test_column_sum_is_lbm_reduce_rows_order():
    """Thread t of 256 adds entries t, t + 256, ... in turn, then a halving
    tree: spelled out here in float32 numpy for 600 entries."""
    v = np.random.default_rng(2).random(600).astype(np.float32)
    acc = np.zeros(256, np.float32)
    for t in range(256):
        for b in range(t, 600, 256):
            acc[t] = np.float32(acc[t] + v[b])
    n = 256
    while n > 1:
        n //= 2
        acc[:n] = acc[:n] + acc[n:2 * n]
    assert fused_torch.column_sum(torch.from_numpy(v)).item() == acc[0]


# lbm_tpu's forced blocked kernel at its default limit takes 8-row blocks.
@pytest.mark.parametrize(
    "ny,steps,chunk,row",
    [(32, 5, 4, 30), (32, 7, 7, 16), (64, 6, 3, 5), (64, 7, 7, 39)],
    ids=lambda v: str(v))
def test_plain_b4_matches_lbm_tpu_blocked_kernel(ny, steps, chunk, row):
    """The plain B4 on 32x128 and 64x128 (4 and 8 row blocks of 8), the
    driven row in the first block, a middle one, on a block edge and in the
    last (its place in the scene), against lbm_tpu's B4 in interpret mode."""
    import jax
    import jax.numpy as jnp

    from lbm_tpu.ops import resident_pallas
    from lbm_tpu.params import LBMParams as JParams

    nx = 128
    params, mask = _scene(ny, nx)
    p = with_driven_row(params, row)
    jp = with_driven_row(JParams(**dataclasses.asdict(params)), row)
    f0 = _mixed(p)
    f_t, tot_t = blocked_cuda.run_plain(torch.from_numpy(f0), torch.from_numpy(mask), p, steps,
                                        block_rows=8)
    run = jax.jit(resident_pallas.make_run_all(jp, mask, steps, chunk=chunk, interpret=True,
                                               force_blocked=True, block_rows=8))
    f_j, tot_j = run(jnp.asarray(f0))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=5e-8)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-5)


@pytest.mark.parametrize("ny,nx,B", [(32, 128, 8), (30, 100, 8), (17, 33, 4), (9, 40, 16)],
                         ids=str)
def test_plain_b4_fields_equal_the_twin(ny, nx, B):
    """Row blocks change only the order of the |u| additions: fields equal
    the twin's bitwise at any ny (a partial last block) and any nx."""
    params, mask = _scene(ny, nx)
    f0, obst = torch.from_numpy(_mixed(params)), torch.from_numpy(mask)
    f_b, tot_b = fused_torch.blocked_chunk(f0, obst, params, 7, B)
    f_t, tot_t = fused_torch.run_steps(f0, obst, params, 7)
    assert torch.equal(f_b, f_t)
    torch.testing.assert_close(tot_b, tot_t, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 8), (5, 5), (0, 256), (9, 2)], ids=str)
def test_blocked_run_all_on_cpu_equals_plain(steps, chunk):
    params, mask = _scene(30, 100)
    f0, obst = torch.from_numpy(_mixed(params)), torch.from_numpy(mask)
    f_k, tot_k = blocked_cuda.make_run_all(params, obst, steps, chunk=chunk)(f0)
    f_p, tot_p = blocked_cuda.run_plain(f0, obst, params, steps)
    assert torch.equal(f_k, f_p) and torch.equal(tot_k, tot_p) and tot_k.shape == (steps,)


# K10's work map (csrc/blocked.cu), modelled here: row blocks of B rows (a
# partial last one where B does not divide ny), tiles of 32 columns walked
# by W = 1, 2, 4 or 8 warps of a block (``_warps_per_tile``, the kernel's
# ``warps_per_tile``), on the grid an H100 gives (132 SMs x 4 blocks of 256
# at most, one block per two tile warps).
WARPS_PER_BLOCK = 8
TARGET_WARPS = 4096  # csrc/blocked.cu kTargetWarps
MAX_GROUP_ROWS = 16  # csrc/blocked.cu kMaxGroupRows


def _warps_per_tile(ny, nx, B):
    """W: doubled from 1 up to 8 while each warp keeps at least two rows
    (4W divides B <= 16) and the doubled split keeps within TARGET_WARPS
    warps; 1 where 9 planes reach 2^31 elements (the long long form)."""
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    W = 1
    while (W < WARPS_PER_BLOCK and B <= MAX_GROUP_ROWS and B % (4 * W) == 0
           and 9 * ny * nx < 2**31 and nby * nbw * 2 * W <= TARGET_WARPS):
        W *= 2
    return W


def _tile_walk(ny, nx, B, grid):
    """Each group of W warps' tiles [k0, k1), as (row block, column tile) in
    its order (the last ceil(nx / 32) warps of the grid sum columns; groups
    lie within a block)."""
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    ntiles = nby * nbw
    groups = (grid * WARPS_PER_BLOCK - nbw) // _warps_per_tile(ny, nx, B)
    return [[divmod(k, nbw) for k in range(g * ntiles // groups, (g + 1) * ntiles // groups)]
            for g in range(groups)]


def _tile_cells(by, bx, ny, nx, B):
    """Tile (by, bx)'s cells in the kernel's order, as ((row, column), warp,
    row of the warp): warp g takes rows [g R, g R + R) of the row block, R =
    B / W, within the grid; warp 0 adds the rows' |u| in this order."""
    W = _warps_per_tile(ny, nx, B)
    R = B // W
    out = []
    for g in range(W):
        for m in range(R):
            j = by * B + g * R + m
            if j < ny:
                out += [((j, i), g, m) for i in range(bx * 32, min(bx * 32 + 32, nx))]
    return out


def _tile_deps(by, bx, ny, nx, B):
    """The tiles whose counters tile (by, bx) waits on: the 3 x 3 around
    it, y and x wrapping."""
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    return {((by + dy) % nby, (bx + dx) % nbw) for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
K10_WALK_CASES = [(30, 100, 16), (17, 33, 4), (9, 40, 16), (64, 64, 8), (60, 100, 8),
                  (72, 100, 16), (512, 512, 16), (1024, 1024, 16), (768, 768, 8),
                  (256, 256, 16), (40, 33, 2), (5, 200, 32)]


def _k10_grid(ny, nx, B, cap=132 * 4):
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    return min(cap, -(-(nby * nbw * _warps_per_tile(ny, nx, B) + nbw) // 2))


@pytest.mark.parametrize("ny,nx,B", K10_WALK_CASES, ids=str)
def test_k10_walk_computes_each_cell_once(ny, nx, B):
    """Every step computes each cell once: the groups' tiles cover the row
    blocks and column tiles once each, and a tile's warps its B x 32 cells
    once each, at their own row and column."""
    seen = np.zeros((ny, nx), dtype=np.int64)
    walked = [t for warp in _tile_walk(ny, nx, B, _k10_grid(ny, nx, B))
              for t in warp]
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    assert sorted(walked) == [(by, bx) for by in range(nby) for bx in range(nbw)]
    for by, bx in walked:
        for (j, i), _, _ in _tile_cells(by, bx, ny, nx, B):
            seen[j, i] += 1
    assert (seen == 1).all()


def test_k10_warp_groups_fill_small_grids():
    """W doubles to at most 8 while each warp keeps at least two rows (4W
    divides B <= 16) and the doubled split keeps within 4096 warps (no
    group takes two tiles a step on an H100); 1 where 9 planes reach 2^31
    elements."""
    assert [_warps_per_tile(n, n, 16) for n in (256, 512, 768, 1024, 2048)] == \
        [8, 8, 2, 2, 1]
    assert [_warps_per_tile(n, n, 8) for n in (256, 512, 768, 1024)] == [4, 4, 1, 1]
    assert _warps_per_tile(64, 64, 32) == 1  # more rows than a group holds
    assert _warps_per_tile(64, 64, 2) == 1  # a warp keeps two rows
    assert _warps_per_tile(64, 64, 4) == 2
    assert _warps_per_tile(16000, 16000, 16) == 1


def _speeds(f, obstacles, params):
    """Each cell's |u| in a step from state f (the driven row injected, then
    streamed), and the step's new state: the values K10 sums."""
    omega, w1, w2 = fused_torch.step_constants(params)
    src = f.clone()
    src[:, params.accel_row] = fused_torch.apply_accel_row(
        f[:, params.accel_row], ~obstacles[params.accel_row], w1, w2)
    streamed = list(fused_torch.stream_periodic(src))
    rho, u_x, u_y = stencil_math.moments(streamed)
    u_sq = u_x * u_x + u_y * u_y
    out = torch.stack(stencil_math.collide(streamed, obstacles, omega, rho, u_x, u_y, u_sq))
    return stencil_math.speeds(u_sq, ~obstacles), out


@pytest.mark.parametrize("ny,nx,B", [(30, 100, 16), (17, 33, 4), (45, 40, 8), (9, 40, 16),
                                     (40, 33, 2)], ids=str)
def test_k10_grouping_is_the_plain_versions(ny, nx, B):
    """The kernel's order of the |u| additions, followed cell by cell
    (``_tile_cells``: each warp's rows in turn, warp 0 adding them in that
    order; the column pass over the row blocks in block order; then the
    fixed-order column sum), gives ``fused_torch.blocked_chunk``'s tot_u
    bit for bit, also where B does not divide ny: each (row block, column)
    partial adds the block's rows in row order."""
    params, mask = _scene(ny, nx)
    obst = torch.from_numpy(mask)
    f = torch.from_numpy(_mixed(params))
    f_p, tot_p = fused_torch.blocked_chunk(f, obst, params, 3, B)
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    for t in range(3):
        sp, f = _speeds(f, obst, params)
        part = torch.zeros((nby, nx), dtype=torch.float32)
        for by in range(nby):
            for bx in range(nbw):
                rows = {}
                for (j, i), _, _ in _tile_cells(by, bx, ny, nx, B):
                    rows.setdefault(i, []).append(j)
                for i, js in rows.items():
                    assert js == list(range(by * B, min(by * B + B, ny)))
                    acc = torch.zeros((), dtype=torch.float32)
                    for j in js:
                        acc = acc + sp[j, i]
                    part[by, i] = acc
        col = torch.zeros(nx, dtype=torch.float32)
        for by in range(nby):
            col = col + part[by]
        assert fused_torch.column_sum(col).item() == tot_p[t].item(), t
    assert torch.equal(f, f_p)


@pytest.mark.parametrize("ny,nx,B", K10_WALK_CASES[:6] + [(20, 8, 16), (40, 64, 16)], ids=str)
def test_k10_tile_waits_cover_both_hazards(ny, nx, B):
    """A tile's step t + 1 waits on the 3 x 3 tiles around it (y and x
    wrapping): every tile that wrote at step t a cell it reads (read after
    write) and every tile that read at step t a cell it overwrites (write
    after read); both sets are that neighbourhood."""
    nby, nbw = blocked_cuda.tiles(ny, nx, B)
    owner = np.full((ny, nx), -1)
    for by in range(nby):
        for bx in range(nbw):
            for (j, i), _, _ in _tile_cells(by, bx, ny, nx, B):
                owner[j, i] = by * nbw + bx
    near = {}  # tile -> tiles owning a cell in its cells' 3 x 3 neighbourhoods
    for by in range(nby):
        for bx in range(nbw):
            cells = np.array([c for c, _, _ in _tile_cells(by, bx, ny, nx, B)])
            hit = set()
            for dj in (-1, 0, 1):
                for di in (-1, 0, 1):
                    hit |= set(owner[(cells[:, 0] + dj) % ny, (cells[:, 1] + di) % nx].tolist())
            near[by * nbw + bx] = hit
    for k, hit in near.items():
        deps = {qy * nbw + qx for qy, qx in _tile_deps(*divmod(k, nbw), ny, nx, B)}
        war = {q for q, h in near.items() if k in h}
        assert hit <= deps and war <= deps, (k, sorted(hit - deps), sorted(war - deps))


def test_k10_sync_and_partials_layout():
    """The wrapper's step counters: a 128-byte line (32 words) per tile and
    per column pass of 32 columns; the ring of PART_SLOTS slots of (row
    blocks, nx) column partials; a group's shared speeds hold its B <=
    MAX_GROUP_ROWS rows."""
    assert blocked_cuda.COUNTER_WORDS * 4 == 128
    for ny, nx, B in K10_WALK_CASES:
        nby, nbw = blocked_cuda.tiles(ny, nx, B)
        assert blocked_cuda.sync_words(ny, nx, B) == 32 * (nby * nbw + -(-nx // 32))
        assert _warps_per_tile(ny, nx, B) == 1 or B <= MAX_GROUP_ROWS
    assert blocked_cuda.sync_words(1024, 1024, 16) == 32 * (64 * 32 + 32)
    assert blocked_cuda.PART_SLOTS == 4


def test_blocked_refuses_int16_and_bad_blocks():
    params, mask = _scene(16, 16)
    with pytest.raises(ValueError, match="maps only the in-place resident kernel"):
        blocked_cuda.make_run_all(params, torch.from_numpy(mask), 4, storage="i16")
    with pytest.raises(ValueError, match="block_rows must divide 256"):
        blocked_cuda.make_run_all(params, torch.from_numpy(mask), 4, block_rows=3)


@pytest.mark.parametrize(
    "kind,grid,storage,want",
    [("mono", 64, "f32", "cuda-resident"), ("mono", 1024, "f32", None),
     ("mono", 64, "i16", None), ("inplace", 512, "f32", "cuda-inplace"),
     ("inplace", 2048, "f32", None), ("inplace", 256, "i16", "cuda-inplace-i16"),
     ("inplace", 512, "i16", "cuda-inplace-i16"), ("inplace", 2048, "i16", None),
     ("blocked", 64, "f32", "cuda-blocked"),
     ("blocked", 4096, "f32", "cuda-blocked"), ("blocked", 64, "i16", None),
     ("auto", 64, "f32", "cuda-resident"), ("auto", 1024, "f32", "cuda-inplace")],
    ids=lambda v: str(v))
def test_resident_kind_policy(monkeypatch, kind, grid, storage, want):
    """LBM_RESIDENT_KIND forces K2, K3 or K10 whatever --temporal-k is, and
    raises where the kind cannot map; auto keeps the policy and never picks
    K10."""
    monkeypatch.setenv("LBM_RESIDENT_KIND", kind)
    p = LBMParams(nx=grid, ny=grid, max_iters=1, reynolds_dim=10, density=0.1, accel=0.01,
                  omega=1.85)
    for temporal_k in (None, 1, 4):
        if want is None:
            with pytest.raises(ValueError, match=f"LBM_RESIDENT_KIND={kind}"):
                program.cuda_choice(p, storage, temporal_k)
        elif kind == "auto":
            assert program.cuda_choice(p, storage)[0] == want
        else:
            assert program.cuda_choice(p, storage, temporal_k) == (want, 1)
    monkeypatch.setenv("LBM_RESIDENT_KIND", "bogus")
    with pytest.raises(ValueError, match="LBM_RESIDENT_KIND='bogus'"):
        program.cuda_choice(p, storage)


def test_forced_blocked_run_through_the_driver(monkeypatch, capsys, tmp_path):
    """``LBM_RESIDENT_KIND=blocked`` runs cuda-blocked (K10's plain version
    on the CPU): fields equal the torch run's, av within float-sum order;
    a kind that cannot map exits 1 through the CLI."""
    from lbm_tpu_torch import cli
    from lbm_tpu_torch.tools import scenegen

    params, mask = _scene(24, 40)
    scene = Scene(params, mask)
    monkeypatch.setenv("LBM_RESIDENT_KIND", "blocked")
    res = driver.run_simulation(scene, driver.RunConfig(variant="cuda", device="cpu",
                                                        num_steps=13, temporal_k=4))
    monkeypatch.delenv("LBM_RESIDENT_KIND")
    ref = driver.run_simulation(scene, driver.RunConfig(variant="torch", device="cpu",
                                                        num_steps=13))
    assert res.variant == "cuda-blocked"
    np.testing.assert_array_equal(res.f, ref.f)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-6)
    monkeypatch.setenv("LBM_RESIDENT_KIND", "mono")
    pfile, ofile = scenegen.write_scene(str(tmp_path), "cylinder", params)
    assert cli.main(["run", pfile, ofile, "--device", "cpu", "--storage", "i16",
                     "--out-dir", str(tmp_path / "out")]) == 1
    assert "LBM_RESIDENT_KIND=mono" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,chunk", [(7, 4), (8, 8), (5, 5)], ids=str)
@pytest.mark.parametrize("shape,row", [((60, 100), 58), ((60, 100), 3), ((64, 64), 39),
                                       ((17, 33), 8)], ids=str)
def test_k10_matches_plain_on_card(cuda_device, shape, row, steps, chunk):
    params, mask = _scene(*shape)
    p = with_driven_row(params, row)
    f0 = torch.from_numpy(_mixed(p)).to(cuda_device)
    obst = torch.from_numpy(mask).to(cuda_device)
    f_k, tot_k = (t.clone() for t in blocked_cuda.make_run_all(p, obst, steps, chunk=chunk)(f0))
    f_p, tot_p = blocked_cuda.run_plain(f0, obst, p, steps)
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B", [((64, 100), 16), ((48, 200), 8), ((128, 128), 16),
                                     ((1024, 1024), 16), ((70, 100), 32)], ids=str)
def test_k10_driven_row_at_tile_edges_on_card(cuda_device, shape, B):
    """The driven row on the first and the last row of a row block (a
    tile's edge: rows B - 1 and B), on row 0 and on row ny - 1 (y wraps),
    with 1 (B = 32), 2 (1024^2), 4 (B = 8) or 8 warps a tile: fields and
    tot_u equal."""
    params, mask = _scene(*shape)
    obst = torch.from_numpy(mask).to(cuda_device)
    for row in (0, B - 1, B, shape[0] - 1):
        p = with_driven_row(params, row)
        f0 = torch.from_numpy(_mixed(p)).to(cuda_device)
        f_k, tot_k = (t.clone() for t in blocked_cuda.make_run_all(
            p, obst, 5, chunk=5, block_rows=B)(f0))
        f_p, tot_p = blocked_cuda.run_plain(f0, obst, p, 5, block_rows=B)
        assert torch.equal(f_k, f_p), (row, float((f_k - f_p).abs().max()))
        assert torch.equal(tot_k, tot_p), row


@pytest.mark.cuda
def test_k10_repeats_bitwise_on_card(cuda_device):
    """Two launches from the same state give the same fields and tot_u,
    bit for bit (no float atomics; the counters zeroed per launch)."""
    params, mask = _scene(96, 160)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = torch.from_numpy(_mixed(params)).to(cuda_device)
    run = blocked_cuda.make_run_all(params, obst, 300, chunk=256)
    f1, t1 = (t.clone() for t in run(f0))
    f2, t2 = run(f0)
    assert torch.equal(f1, f2) and torch.equal(t1, t2)


@pytest.mark.cuda
def test_k10_counts_its_launches_and_refuses_cpu_state(cuda_device):
    params, mask = _scene(32, 64)
    obst = torch.from_numpy(mask).to(cuda_device)
    before = LAUNCHES["K10"]
    run = blocked_cuda.make_run_all(params, obst, 600, chunk=256)
    f, tot = run(torch.from_numpy(_mixed(params)).to(cuda_device))
    assert LAUNCHES["K10"] == before + 3 and tot.shape == (600,)
    assert bool(torch.isfinite(f).all())
    with pytest.raises(ValueError, match="state on the CPU"):
        run(torch.from_numpy(_mixed(params)))
