"""K6, the ghosted chunk kernel of the chunked mode (ops/ghosted_cuda.py):
its plain version against lbm_tpu's ``make_ghosted_chunk_runner``
(interpret mode on the CPU), its mapping rule, its wrapper's checks, and
the chunked program's choice of it.

Against lbm_tpu the fields agree within atol 2e-7 after a 4-step chunk and
the per-step sums within rtol 1e-4 (XLA on the CPU contracts multiply-adds
into FMAs, torch does not: ROADMAP queue C).  Tests marked ``cuda`` hold
the kernel to its plain version on the card, bitwise, and skip without one;
lbm_tpu is imported inside the test that uses it, so that the card, which
has no jax, runs them (``python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_ghosted.py``).
"""

import warnings

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import fused_cuda, ghosted_cuda, resident_cuda
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.parallel import mesh, modes

torch.set_num_threads(1)


def _params(ny, nx):
    return LBMParams(nx=nx, ny=ny, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
                     omega=1.85)


def _shard(n, nx, seed, p):
    """A seeded perturbed (9, n + 2, nx) slab, the guard false at every third
    cell, and an obstacle slab with walls on the edge columns and a block."""
    rng = np.random.default_rng(seed)
    f = lattice.equilibrium_rest(p.density, n + 2, nx) * (
        np.float32(1) + rng.uniform(-0.1, 0.1, (9, n + 2, nx)).astype(np.float32))
    f[3, :, ::3] = lattice.accel_weights(p.density, p.accel)[0] * np.float32(0.5)
    m = np.zeros((n + 2, nx), dtype=bool)
    m[:, 0] = m[:, -1] = True
    m[3:5, 20:24] = True
    return f, m


@pytest.mark.parametrize("shard", [0, 1])
def test_k6_plain_matches_pallas_ghosted_chunk(shard):
    """32 x 128 over 2 shards, chunk 4 (tests/test_parallel.py:298): shard 1
    holds the driven row (global row 30) in its body, shard 0 in none."""
    import jax.numpy as jnp

    from lbm_tpu.ops import resident_pallas
    from lbm_tpu.params import LBMParams as JParams

    p = _params(32, 128)
    n, chunk, off = 16, 4, 16 * shard
    f, m = _shard(n, p.nx, 11 + shard, p)
    jrun = resident_pallas.make_ghosted_chunk_runner(
        JParams(nx=p.nx, ny=p.ny, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
                omega=1.85), n, p.nx, chunk, interpret=True)
    jf, jav = jrun(jnp.asarray(f[:, 1:-1]), jnp.asarray(f[:, :1]), jnp.asarray(f[:, -1:]),
                   jnp.asarray(m.astype(np.float32)), off)
    t = torch.from_numpy(f)
    out = torch.empty((9, n, p.nx), dtype=torch.float32)
    tots = torch.empty(chunk, dtype=torch.float32)
    launch = ghosted_cuda.bind_chunk(p, t[:, 1:-1].contiguous(), t[:, :1], t[:, -1:],
                                     torch.from_numpy(m), out, tots, off, chunk)
    launch(0)
    np.testing.assert_allclose(launch.result.numpy(), np.asarray(jf), atol=2e-7, rtol=0)
    np.testing.assert_allclose(tots.numpy(), np.asarray(jav), rtol=1e-4)


@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
@pytest.mark.parametrize("where", ["body", "lo", "hi"])
def test_k6_plain_is_frozen_ghost_slab_steps(chunk, where):
    """K6's plain version equals ``chunk`` K1-slab steps (their plain
    version) with the same ghost rows, bitwise, the driven row in the body
    or a ghost."""
    p = _params(64, 24)
    n = 5
    f, m = _shard(n, p.nx, 3, p)
    off = {"body": p.accel_row - 2, "lo": p.accel_row + 1, "hi": p.accel_row - n}[where]
    t, mt = torch.from_numpy(f), torch.from_numpy(m)
    body, lo, hi = t[:, 1:-1].contiguous(), t[:, :1], t[:, -1:]
    f_in, out = body.clone(), torch.empty_like(body)
    tots = torch.zeros(chunk + 2, dtype=torch.float32)
    launch = ghosted_cuda.bind_chunk(p, f_in, lo, hi, mt, out, tots, off, chunk)
    launch(2)
    x, y = body.clone(), torch.empty_like(body)
    ref_tots = torch.zeros(chunk, dtype=torch.float32)
    for s in range(chunk):
        fused_cuda.bind_slab_step(p, x, lo, hi, mt, y, ref_tots, off)(s)
        x, y = y, x
    # The two buffers ping-pong: an odd chunk ends in out, an even one in f.
    assert launch.result is (out if chunk % 2 else f_in)
    assert torch.equal(launch.result, x)
    assert torch.equal(tots[2:], ref_tots)


def test_k6_mapping_rule():
    """Two f32 copies of the shard within the L2 budget (42 MiB): the 1024^2
    golden grid over 4 shards maps, 4096^2 over 4 does not."""
    assert ghosted_cuda.supports_shard(256, 1024)
    assert ghosted_cuda.supports_shard(16, 100)
    assert not ghosted_cuda.supports_shard(1024, 4096)
    assert ghosted_cuda.supports_shard(16, 128) == resident_cuda.fits_l2(16, 128)


def test_k6_wrapper_checks():
    p = _params(32, 16)
    f = torch.zeros((9, 4, 16))
    g = torch.zeros((9, 1, 16))
    m = torch.zeros((6, 16), dtype=torch.bool)
    tots = torch.zeros(3)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        ghosted_cuda.bind_chunk(p, f, g, g, m, torch.empty_like(f), tots, 0, 0)
    with pytest.raises(ValueError, match="obstacle slab"):
        ghosted_cuda.bind_chunk(p, f, g, g, m[1:], torch.empty_like(f), tots, 0, 2)
    with pytest.raises(ValueError, match="shape"):
        ghosted_cuda.bind_chunk(p, f, torch.zeros((9, 2, 16)), g, m, torch.empty_like(f),
                                tots, 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ghosted_cuda.bind_chunk(p, torch.zeros((9, 6, 16))[:, 1:5], g, g, m,
                                torch.empty_like(f), tots, 0, 2)
    with pytest.raises(ValueError, match="float32"):
        ghosted_cuda.bind_chunk(p, f, g, g, m, torch.empty_like(f), tots.double(), 0, 2)


@pytest.mark.parametrize("k", [2, 3])
def test_chunked_program_on_k6_equals_the_slab_loop(k):
    """The chunked program maps K6 on the cuda backend (its plain version on
    the CPU) and the K1-slab loop on the torch backend: the two routes give
    the same fields and sums."""
    p = _params(16, 16)
    m = np.zeros((16, 16), dtype=bool)
    m[0] = m[-1] = True
    m[:, 0] = m[:, -1] = True
    m[5:7, 8:10] = True
    ms = mesh.make_row_mesh(2, ["cpu"] * 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cuda = modes.build_sharded_program(p, m, ms, "chunked", k, backend="cuda")
        plain = modes.build_sharded_program(p, m, ms, "chunked", k, backend="torch")
    runs = [prog.make_run_all(4 * k)(prog.init_state) for prog in (cuda, plain)]
    assert torch.equal(cuda.f_of(runs[0][0]), plain.f_of(runs[1][0]))
    assert torch.equal(runs[0][1], runs[1][1])
    assert cuda.variant == plain.variant == f"chunked-{k}"


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", [(256, 1024), (13, 100)], ids=str)
@pytest.mark.parametrize("where", ["body", "lo", "hi", "none"])
def test_k6_matches_plain_on_card(cuda_device, chunk, shape, where):
    n, nx = shape
    p = _params(1024, nx)
    f, m = _shard(n, nx, 5, p)
    off = {"body": p.accel_row - n // 2, "lo": p.accel_row + 1, "hi": p.accel_row - n,
           "none": 0}[where]
    t, mt = torch.from_numpy(f).to(cuda_device), torch.from_numpy(m).to(cuda_device)
    body, lo, hi = t[:, 1:-1].contiguous(), t[:, :1], t[:, -1:]
    out = torch.empty_like(body)
    tots = torch.zeros(chunk, dtype=torch.float32, device=cuda_device)
    before = LAUNCHES["K6"]
    launch = ghosted_cuda.bind_chunk(p, body.clone(), lo, hi, mt, out, tots, off, chunk)
    launch(0)
    torch.cuda.synchronize()
    assert LAUNCHES["K6"] == before + 1
    ref, ref_tots = ghosted_cuda.chunk_plain(body, lo, hi, mt, p, off, chunk)
    assert torch.equal(launch.result, ref)
    torch.testing.assert_close(tots, ref_tots, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 3, 8, 256])
@pytest.mark.parametrize("shape", [(13, 100), (30, 129), (8, 1024)], ids=str)
@pytest.mark.parametrize("where", ["split", "first", "last", "lo", "hi", "none"])
def test_k6_band_edges_match_plain_on_card(cuda_device, chunk, shape, where):
    """K6 where the blocks' bands (the band plan on the card's grid) end
    mid-row, with the driven row on a row two bands share (the last row of
    one, the first of the next), on the shard's first or last row (next to
    a ghost), in either ghost, or nowhere; two chunks, through the launcher
    the first one's result asks for (the step counters run on), against
    2 x chunk plain slab steps.  The result lands where the parity puts it."""
    from lbm_tpu_torch.ops import _build

    n, nx = shape
    p = _params(1024, nx)
    f, m = _shard(n, nx, 9, p)
    grid = _build.load().lbm_ghosted_grid(n, nx, cuda_device.index)
    plan = ghosted_cuda.shard_plan(n, nx, grid)[0]
    split = [s // nx for s, _, _, _ in plan if s % nx]
    assert split
    dr = {"split": split[len(split) // 2], "first": 0, "last": n - 1}.get(where)
    off = {"lo": p.accel_row + 1, "hi": p.accel_row - n, "none": 0}.get(
        where, p.accel_row - (dr if dr is not None else 0))
    t, mt = torch.from_numpy(f).to(cuda_device), torch.from_numpy(m).to(cuda_device)
    body, lo, hi = t[:, 1:-1].contiguous(), t[:, :1], t[:, -1:]
    a, b = body.clone(), torch.empty_like(body)
    tots = torch.zeros(2 * chunk, dtype=torch.float32, device=cuda_device)
    fwd = ghosted_cuda.bind_chunk(p, a, lo, hi, mt, b, tots, off, chunk)
    bwd = ghosted_cuda.bind_chunk(p, b, lo, hi, mt, a, tots, off, chunk)
    assert fwd.result is (b if chunk % 2 else a)
    nxt = bwd if fwd.result is b else fwd
    before = LAUNCHES["K6"]
    fwd(0)
    nxt(chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["K6"] == before + 2
    ref, ref_tots = ghosted_cuda.chunk_plain(body, lo, hi, mt, p, off, 2 * chunk)
    assert torch.equal(nxt.result, ref)
    torch.testing.assert_close(tots, ref_tots, rtol=1e-6, atol=0.0)
