"""lbm_tpu_torch's HBM-parts sweep K9 (ops/hbm_cuda.py): its plan of part
rows and slots, a model of its slot schedule held to the pipeline's hazards,
its plain versions against each other and against lbm_tpu's hbm_pallas in
interpret mode, the forced ``LBM_TEMPORAL_IMPL=hbm`` path through the
program and the CLI, and (marked ``cuda``) K9 against its plain versions and
against K1 on the card.

Against ``lbm_tpu`` on the CPU: fields within atol 5e-7 after 16 steps,
tot_u within rtol 1e-4 (tests/test_hbm.py's bounds: XLA contracts
multiply-adds into FMAs, torch does not, ROADMAP queue C).  On the card K9 is
held bitwise to its plain version and to K1 on fields, tot_u within rtol
1e-6 (another summation order), and bitwise to itself across runs.  lbm_tpu
and jax are imported inside the tests that compare against them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hbm.py
"""

import random

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli
from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.models import program
from lbm_tpu_torch.ops import fused_cuda, hbm_cuda, inplace_cuda, resident_cuda
from lbm_tpu_torch.ops._build import LAUNCHES
from lbm_tpu_torch.params import LBMParams, with_driven_row
from lbm_tpu_torch.tools import scenegen

torch.set_num_threads(1)


def _scene(ny, nx, seed):
    """tests/test_hbm.py's scene: 8% random walls, walled top and bottom rows."""
    params = LBMParams(nx=nx, ny=ny, max_iters=16, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    r = np.random.default_rng(seed)
    mask = r.random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return params, mask


def test_plan_and_supports(monkeypatch):
    """(R, S): the largest divisor R of ny with K <= R and R + 2K <= ny whose
    S slots, f32 slabs of (R + 2K, nx), fit the L2 budget, S = 3 where that
    fits, else 2; no K % 8 rule, no 128-lane rule, no three-part minimum;
    f32 only."""
    p, _ = _scene(64, 256, 0)
    assert hbm_cuda.plan(p, 8) == (32, 3) and hbm_cuda.plan(p, 4) == (32, 3)
    assert hbm_cuda.plan(p, 2) == (32, 3)  # 60 rows would fit; 32 is the largest divisor
    assert hbm_cuda.plan(p, 3) == (32, 3)
    assert hbm_cuda.plan(p.replace(ny=60, nx=100), 4) == (30, 3)
    assert hbm_cuda.plan(p.replace(ny=60, nx=100), 8) == (30, 3)
    big = p.replace(ny=2048, nx=2048)
    assert hbm_cuda.plan(big, 4) == (256, 2) and hbm_cuda.plan(big, 8) == (256, 2)
    huge = p.replace(ny=4096, nx=4096)
    assert hbm_cuda.plan(huge, 4) == (128, 2) and hbm_cuda.plan(huge, 8) == (128, 2)
    budget = hbm_cuda.L2_SLOTS_BUDGET
    for q, K in ((big, 4), (big, 8), (huge, 4), (huge, 8)):
        R, S = hbm_cuda.plan(q, K)
        assert S * inplace_cuda.state_bytes(R + 2 * K, q.nx) <= budget
        assert 2 * inplace_cuda.state_bytes(2 * R + 2 * K, q.nx) > budget  # the next divisor
    assert hbm_cuda.plan(p.replace(ny=16, nx=24), 8) is None  # 2K = ny
    assert hbm_cuda.plan(p.replace(ny=17, nx=24), 4) is None  # 17 rows: no part size
    assert hbm_cuda.plan(p, 1) is None and hbm_cuda.plan(p, 0) is None
    assert hbm_cuda.supports(p, 4) and not hbm_cuda.supports(p, 4, "i16")
    assert hbm_cuda.parts_valid(64, 4, 16, 2) and not hbm_cuda.parts_valid(64, 4, 24, 2)
    assert not hbm_cuda.parts_valid(64, 8, 4, 2) and not hbm_cuda.parts_valid(64, 4, 16, 0)
    monkeypatch.setattr(hbm_cuda, "L2_SLOTS_BUDGET", 0)
    assert hbm_cuda.plan(p, 4) is None
    obst = torch.zeros((64, 256), dtype=torch.bool)
    obst[2, 7] = True
    parts = hbm_cuda.part_obstacles(obst, 32, 4)  # rows [-4, 36) and [28, 68) mod 64
    assert parts.shape == (2, 40, 256) and parts.dtype == torch.uint8
    assert parts[0, 6, 7] == 1 and parts[1, 6, 7] == 0
    assert parts[1, 38, 7] == 1  # part 1's upper ghosts wrap to row 2


def _run_schedule(P, S, K, G, pick, wait=hbm_cuda.slot_wait):
    """Run G blocks of :func:`hbm_cuda.slot_schedule` in an order that
    ``pick`` chooses among the blocks whose next event may run (a slot's
    wait holds until every block is done with its parts): the global trace
    of (block, event)."""
    events, _ = hbm_cuda.slot_schedule(P, S, K)
    events = [("wait", e[1], wait(e[1], S)) if e[0] == "wait" else e for e in events]
    pos, parts, trace = [0] * G, [0] * G, []
    while any(i < len(events) for i in pos):
        ready = [b for b in range(G) if pos[b] < len(events)
                 and (events[pos[b]][0] != "wait" or min(parts) >= events[pos[b]][2])]
        b = pick(ready)
        e = events[pos[b]]
        trace.append((b, e))
        pos[b] += 1
        if e[0] == "step" and e[2] == K - 1:
            parts[b] += 1
    return trace


def _slot_hazards(trace, K, G):
    """The parts whose slot a step 0 overwrote in ``trace`` while some of the
    G blocks had still to run a step of the part there before it."""
    done, last, bad = {}, {}, []
    for _, e in trace:
        if e[0] == "step":
            _, q, t, slot = e
            if t == 0 and last.get(slot, q) != q and done.get(last[slot], 0) < G * K:
                bad.append(q)
            last[slot] = q
            done[q] = done.get(q, 0) + 1
    return bad


def _overlaps(trace, K, G):
    """Whether some block loaded a part while another had still to run a
    step of the part before it."""
    done = {}
    for _, e in trace:
        if e[0] == "load" and e[1] > 0 and done.get(e[1] - 1, 0) < G * K:
            return True
        if e[0] == "step":
            done[e[1]] = done.get(e[1], 0) + 1
    return False


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("P", [1, 2, 3, 8, 32])
def test_slot_schedule(P, S, K):
    """The kernel's slot schedule (ops/hbm_cuda.slot_schedule, csrc/hbm.cu):
    every part is computed once, in order, each step once; its load comes
    before its steps; under any order of 4 blocks no slot is overwritten
    before every block has read the part there before it, a wait for one
    part less lets a block do so, and with two slots or more some order
    loads a part while the part before it is still swept; the |u| pass adds
    each level's parts in part order."""
    events, sums = hbm_cuda.slot_schedule(P, S, K)
    steps = [e[1:] for e in events if e[0] == "step"]
    assert steps == [(q, t, q % S) for q in range(P) for t in range(K)]
    for q in range(P):
        assert events.index(("load", q)) < events.index(("step", q, 0, q % S))
    assert sums == [(t, q) for t in range(K) for q in range(P)]
    G = 4
    overlap = False
    for seed in range(20):
        r = random.Random(seed)
        trace = _run_schedule(P, S, K, G, r.choice)
        assert not _slot_hazards(trace, K, G)
        overlap |= _overlaps(trace, K, G)
    assert overlap == (P > 1 and S > 1)
    # One block races ahead while the others lag: waiting for one part
    # less, the racer overwrites a slot they still read.
    racer = _run_schedule(P, S, K, G, lambda ready: ready[-1],
                          wait=lambda q, s: hbm_cuda.slot_wait(q, s) - 1)
    assert bool(_slot_hazards(racer, K, G)) == (P > S)


# Driven rows of a 64-row grid in parts of 16 rows: 62 (the reference's
# ny - 2) in part 3's body and part 0's lower ghosts across the wrap, 1 in
# part 0's body and part 3's upper ghosts across the wrap, 18 in part 1's
# body and part 0's upper ghosts (K = 4 and 8 alike), 40 in part 2's body
# only at K = 4 (also in part 3's lower ghosts at K = 8).
DRIVEN_ROWS = (62, 1, 18, 40)


@pytest.mark.parametrize("row", DRIVEN_ROWS)
@pytest.mark.parametrize("K", [4, 8])
def test_parts_plain_matches_run_plain(K, row):
    """The parts plain version (each part's slab K steps, the parts' |u|
    added in part order) gives the whole-grid plain sweep's fields bitwise
    and its tot_u within rtol 1e-6 (another summation order), over two
    sweeps and a K1 tail, wherever the driven row lies."""
    p, mask = _scene(64, 128, 9)
    p = with_driven_row(p, row)
    obst = torch.from_numpy(mask)
    f0 = _start(p, "mixed", "cpu")
    steps = 2 * K + 1
    f_q, tot_q = hbm_cuda.run_parts_plain(f0, obst, p, steps, K, 16)
    f_p, tot_p = hbm_cuda.run_plain(f0, obst, p, steps, K)
    assert torch.equal(f_q, f_p)
    torch.testing.assert_close(tot_q, tot_p, rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError, match="parts of 24 rows"):
        hbm_cuda.run_parts_plain(f0, obst, p, steps, K, 24)


@pytest.mark.parametrize("row", DRIVEN_ROWS[:3])
def test_parts_plain_matches_lbm_tpu(monkeypatch, row):
    """The parts plain version against hbm_pallas.make_run_all(interpret=True)
    with its part rows pinned to the same 16 (``LBM_HBM_R``: 4 parts of a
    64x128 grid at K = 8, a size B7 maps), 16 steps and 11 (a K1 tail), the
    driven row at the wrap, in a ghost region and across the wrap's other
    side."""
    import jax.numpy as jnp

    from lbm_tpu.ops import hbm_pallas
    from lbm_tpu.params import LBMParams as JParams

    monkeypatch.setenv("LBM_HBM_R", "16")
    p, mask = _scene(64, 128, 4)
    p = with_driven_row(p, row)
    jp = with_driven_row(JParams(nx=128, ny=64, max_iters=16, reynolds_dim=10, density=0.1,
                                 accel=0.005, omega=1.85), row)
    assert hbm_pallas._plan(jp, 8)[0] == 16
    f0 = _start(p, "mixed", "cpu")
    for steps in (16, 11):
        f_j, tot_j = hbm_pallas.make_run_all(jp, mask, steps, 8, interpret=True)(
            jnp.asarray(f0.numpy()))
        f_q, tot_q = hbm_cuda.run_parts_plain(f0, torch.from_numpy(mask), p, steps, 8, 16)
        np.testing.assert_allclose(f_q.numpy(), np.asarray(f_j), atol=5e-7, rtol=0)
        np.testing.assert_allclose(tot_q.numpy(), np.asarray(tot_j), rtol=1e-4)


def test_forced_hbm_through_the_program(monkeypatch):
    """LBM_TEMPORAL_IMPL=hbm: cuda-hbm where K9 maps (the CPU runs its plain
    version: bitwise the K1 loop), and a ValueError where it does not; auto
    never takes it."""
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    monkeypatch.setattr(inplace_cuda, "L2_INPLACE_BUDGET", 2**20)
    p, mask = _scene(64, 100, 5)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL", raising=False)
    assert program.temporal_impl_choice(p, 4) == "trapezoid"
    monkeypatch.setenv("LBM_TEMPORAL_IMPL", "hbm")
    assert program.temporal_impl_choice(p, 4) == "hbm"
    assert program.temporal_impl_choice(p, 3) == "hbm"
    with pytest.raises(ValueError, match="cannot map"):
        program.temporal_impl_choice(p, 4, "i16")
    with pytest.raises(ValueError, match="cannot map"):
        program.temporal_impl_choice(p.replace(ny=12), 8)
    prog = program.build_single_program(p, mask, "cpu", backend="cuda", temporal_k=4)
    assert prog.variant == "cuda-hbm" and prog.sweep_k == 4
    f_h, tot_h = prog.make_run_all(14)(prog.init_state)
    monkeypatch.delenv("LBM_TEMPORAL_IMPL")
    k1 = program.build_single_program(p, mask, "cpu", backend="cuda", temporal_k=1)
    f_1, tot_1 = k1.make_run_all(14)(k1.init_state)
    assert torch.equal(f_h, f_1)
    torch.testing.assert_close(tot_h, tot_1, rtol=1e-6, atol=0.0)


def test_cli_forced_hbm(tmp_path, capsys, monkeypatch):
    """``run --temporal-k 2`` under LBM_TEMPORAL_IMPL=hbm reports cuda-hbm
    and writes the K1 run's final_state.dat byte for byte."""
    monkeypatch.setattr(resident_cuda, "L2_STATE_BUDGET", 0)
    params = LBMParams(nx=24, ny=16, max_iters=9, reynolds_dim=10, density=0.1, accel=0.005,
                       omega=1.85)
    pfile, ofile = scenegen.write_scene(str(tmp_path / "scene"), "cylinder", params)
    outs = {}
    for impl, k in (("hbm", "2"), ("auto", "1")):
        monkeypatch.setenv("LBM_TEMPORAL_IMPL", impl)
        out = tmp_path / impl
        assert cli.main(["run", pfile, ofile, "--device", "cpu", "--variant", "cuda",
                         "--temporal-k", k, "--out-dir", str(out)]) == 0
        outs[impl] = out
    assert "Variant:\t\t\tcuda-hbm\n" in capsys.readouterr().out
    assert ((outs["hbm"] / "final_state.dat").read_bytes()
            == (outs["auto"] / "final_state.dat").read_bytes())


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _start(p, kind, device):
    f = lattice.equilibrium_rest(p.density, p.ny, p.nx)
    if kind == "mixed":
        rng = np.random.default_rng(11)
        f = f * (np.float32(1.0) + rng.uniform(-0.1, 0.1, size=f.shape).astype(np.float32))
        w1, _ = lattice.accel_weights(p.density, p.accel)
        f[3, p.accel_row, ::3] = w1 * np.float32(0.5)
    return torch.from_numpy(f).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rest", "mixed"])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(64, 256), (60, 100)], ids=str)
def test_k9_matches_plain_and_k1_on_card(cuda_device, shape, K, kind):
    """K9 over 2K + 1 steps (two sweeps and a K1 tail) against its plain
    version and against the K1 loop: fields equal, tot_u within rtol 1e-6;
    its launches counted."""
    p, mask = _scene(*shape, 7)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _start(p, kind, cuda_device)
    steps = 2 * K + 1
    before = LAUNCHES["K9"]
    f_k, tot_k = (t.clone() for t in hbm_cuda.make_run_all(p, obst, steps, K)(f0))
    assert LAUNCHES["K9"] == before + 2
    f_p, tot_p = hbm_cuda.run_plain(f0, obst, p, steps, K)
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-6, atol=0.0)
    f_1, tot_1 = fused_cuda.make_run_all(p, obst, steps)(f0)
    assert torch.equal(f_k, f_1)
    torch.testing.assert_close(tot_k, tot_1, rtol=1e-6, atol=0.0)


# (ny, nx, R, S, K) pinned: 2 and 3 parts, 3 parts in 3 slots (no slot
# reused), 4 parts at K = 8, 32 parts in 2 and 3 slots, and one slot (every
# part waits for every block to be done with the one before it).
PINNED = ((96, 128, 48, 2, 4), (96, 128, 32, 2, 4), (96, 128, 32, 3, 4), (64, 100, 16, 2, 8),
          (256, 96, 8, 2, 4), (256, 96, 8, 3, 8), (128, 128, 32, 1, 4), (256, 96, 8, 1, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["default", "upper ghost", "lower ghost", "wrap"])
@pytest.mark.parametrize("case", PINNED, ids=str)
def test_k9_parts_slots_and_driven_rows_on_card(cuda_device, case, where):
    """K9 on pinned part rows and slots, the driven row at ny - 2, in part 1's
    body and part 0's upper ghosts (R + 1), in part 0's body and part 1's
    lower ghosts (R - 1), and in row 0 (the last part's upper ghosts across
    the wrap): fields equal to the plain sweep, tot_u within rtol 1e-6 of
    the parts plain version, a second run bitwise equal, one launch per
    sweep."""
    ny, nx, R, S, K = case
    p, mask = _scene(ny, nx, 13)
    row = {"default": ny - 2, "upper ghost": R + 1, "lower ghost": R - 1, "wrap": 0}[where]
    p = with_driven_row(p, row)
    obst = torch.from_numpy(mask).to(cuda_device)
    f0 = _start(p, "mixed", cuda_device)
    steps = 3 * K + 1
    run = hbm_cuda.make_run_all(p, obst, steps, K, rows=R, slots=S)
    before = LAUNCHES["K9"]
    f_k, tot_k = (t.clone() for t in run(f0))
    assert LAUNCHES["K9"] == before + 3
    f_p, _ = hbm_cuda.run_plain(f0, obst, p, steps, K)
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    _, tot_q = hbm_cuda.run_parts_plain(f0, obst, p, steps, K, R)
    torch.testing.assert_close(tot_k, tot_q, rtol=1e-6, atol=0.0)
    f_2, tot_2 = run(f0)
    assert torch.equal(f_2, f_k) and torch.equal(tot_2, tot_k)
