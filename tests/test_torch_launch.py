"""The port's one launch path (ops/_build.py ``launch``, ``bind``,
``LAUNCHES``) and the wrappers' card-or-plain builders (ops/_runner.py), on
the CPU.

A fake library stands in for the kernel library: ``launch`` and a launcher
``bind`` made call its entry point, raise with that library's own error
text, and count by the kernel's form.  Every wrapper's CPU runner or binder launches nothing, and
refuses a state on another device (a ``meta`` tensor stands in for a card
state on a host without one).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import (
    _build,
    _runner,
    blocked_cuda,
    ca_cuda,
    ensemble_cuda,
    fused_cuda,
    ghosted_cuda,
    hbm_cuda,
    inplace_cuda,
    quant,
    resident_cuda,
    skew_cuda,
    temporal_cuda,
)
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import verify_device

torch.set_num_threads(1)
NY, NX, N, K = 16, 24, 8, 2  # the grid; a shard's rows and a sweep's depth


class FakeLib:
    """An entry point ``lbm_fake`` returning ``rc``, and the library's
    error text."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def lbm_fake(self, *args):
        self.calls.append(args)
        return self.rc

    def lbm_error_string(self, rc):
        return f"fake error {rc}".encode()


def test_launch_counts_a_zero_rc_under_the_kernels_name():
    lib, before = FakeLib(0), dict(_build.LAUNCHES)
    _build.launch(lib, "lbm_fake", "K3", 1, 2.5, None, n=7)
    _build.launch(lib, "lbm_fake", "K11", 3)
    assert lib.calls == [(1, 2.5, None), (3,)]
    assert _build.LAUNCHES["K3"] == before.get("K3", 0) + 7
    assert _build.LAUNCHES["K11"] == before.get("K11", 0) + 1


def test_launch_raises_with_the_librarys_text_and_counts_nothing():
    lib, before = FakeLib(700), dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match=r"K5-i16 \(lbm_fake\) failed: CUDA error 700 "
                                           r"\(fake error 700\)"):
        _build.launch(lib, "lbm_fake", "K5-i16", 1, n=3)
    assert lib.calls == [(1,)] and dict(_build.LAUNCHES) == before


def test_launch_refuses_a_name_outside_the_table():
    lib, before = FakeLib(0), dict(_build.LAUNCHES)
    for name in ("K12", "K3-f32", "lbm_inplace_chunk", ""):
        with pytest.raises(ValueError, match="unknown kernel form"):
            _build.launch(lib, "lbm_fake", name)
    assert lib.calls == [] and dict(_build.LAUNCHES) == before


def test_bind_makes_a_launcher_that_counts_each_call_and_keeps_its_sums_in_range():
    tots = torch.zeros(8, dtype=torch.float32)
    lib, before = FakeLib(0), dict(_build.LAUNCHES)
    launch = _build.bind(lib, "lbm_fake", "K4-slab", (1, 2), tots, 4, (7,), keep=(tots,))
    launch(0)
    launch(4)
    assert lib.calls == [(1, 2, tots.data_ptr(), 7), (1, 2, tots.data_ptr() + 16, 7)]
    assert _build.LAUNCHES["K4-slab"] == before.get("K4-slab", 0) + 2
    assert launch.keep == (tots,)
    for t0 in (-1, 5, 8):
        with pytest.raises(IndexError):
            launch(t0)
    assert len(lib.calls) == 2
    lib.rc = 2
    with pytest.raises(RuntimeError, match=r"K4-slab \(lbm_fake\) failed: CUDA error 2 "
                                           r"\(fake error 2\)"):
        launch(1)
    assert _build.LAUNCHES["K4-slab"] == before.get("K4-slab", 0) + 2
    with pytest.raises(ValueError, match="unknown kernel form"):
        _build.bind(lib, "lbm_fake", "K4-slab-f32", (), tots, 1, (), keep=())


def test_the_probes_are_the_kernel_forms():
    assert verify_device.PROBES is _build.KERNEL_FORMS
    assert len(_build.KERNEL_FORMS) == len(set(_build.KERNEL_FORMS)) == 22


def test_chunk_lengths_and_forms():
    assert _runner.chunk_lengths(0, 256) == []
    assert _runner.chunk_lengths(7, 4) == [4, 3]
    assert _runner.chunk_lengths(8, 4) == [4, 4]
    assert _runner.chunk_lengths(5, 8) == [5]
    assert _runner.chunk_lengths(600, 256) == [256, 256, 88]
    assert _runner.form("K3", "f32") == "K3" and _runner.form("K1-slab", "i16") == "K1-slab-i16"
    assert {_runner.form(k, s) for k in ("K1", "K3", "K4", "K5", "K8", "K1-slab", "K4-slab")
            for s in ("f32", "i16")} <= set(_build.KERNEL_FORMS)


def _params():
    return LBMParams(nx=NX, ny=NY, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
                     omega=1.85)


def _mask():
    mask = np.zeros((NY, NX), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[5:7, 9:12] = True
    return torch.from_numpy(mask)


def _state(rows=NY, storage="f32"):
    rng = np.random.default_rng(rows)
    f = torch.from_numpy((0.1 / 9 * (1 + 0.01 * rng.random((9, rows, NX)))).astype(np.float32))
    return quant.quantize(f, 0.1) if storage == "i16" else f


# Each wrapper's runner, built on a CPU mask.
RUNNERS = {
    "K1": lambda p, m: fused_cuda.make_run_all(p, m, 3),
    "K1-i16": lambda p, m: fused_cuda.make_run_all(p, m, 3, "i16"),
    "K2": lambda p, m: resident_cuda.make_run_all(p, m, 5, chunk=2),
    "K3": lambda p, m: inplace_cuda.make_run_all(p, m, 5, chunk=2),
    "K3-i16": lambda p, m: inplace_cuda.make_run_all(p, m, 5, chunk=2, storage="i16"),
    "K4": lambda p, m: temporal_cuda.make_run_all(p, m, 5, K),
    "K5": lambda p, m: skew_cuda.make_run_all(p, m, 5, K),
    "K9": lambda p, m: hbm_cuda.make_run_all(p, m, 5, K),
    "K10": lambda p, m: blocked_cuda.make_run_all(p, m, 5, chunk=2),
}


@pytest.mark.parametrize("kernel", sorted(RUNNERS))
def test_cpu_runner_launches_nothing_and_refuses_another_device(kernel):
    p, m = _params(), _mask()
    storage = "i16" if kernel.endswith("-i16") else "f32"
    run = RUNNERS[kernel](p, m)
    before = dict(_build.LAUNCHES)
    f, tot = run(_state(storage=storage))
    assert dict(_build.LAUNCHES) == before
    assert f.shape == (9, NY, NX) and tot.dtype == torch.float32 and tot.numel() >= 3
    with pytest.raises(ValueError):
        run(torch.empty((9, NY, NX), dtype=_runner.STATE_DTYPES[storage], device="meta"))


def test_cpu_ensemble_runner_launches_nothing_and_refuses_another_device():
    p, m = _params(), _mask()
    run = ensemble_cuda.make_run_all(p, m, [1.3, 1.6], None, 3)
    assert run.kernel == "plain" and run.plan is None
    before = dict(_build.LAUNCHES)
    f_b, tot = run(torch.stack([_state(), _state()]))
    assert dict(_build.LAUNCHES) == before and tot.shape == (3, 2)
    with pytest.raises(ValueError):
        run(torch.empty((2, 9, NY, NX), device="meta"))


def _slab_args(k, rows=N):
    """(body, lo, hi, obstacle slab, out, tots) of a shard of ``rows`` body
    rows with ``k`` ghost rows a side."""
    x = _state(rows + 2 * k)
    body, lo, hi = x[:, k:k + rows].contiguous(), x[:, :k].clone(), x[:, k + rows:].clone()
    obst = _mask()[:rows + 2 * k].contiguous()
    return body, lo, hi, obst, torch.empty_like(body), torch.zeros(max(k, 2), dtype=torch.float32)


# Each binder: bind(params, body, lo, hi, obst, out, tots) -> launch(t), and
# its ghost rows a side.
BINDERS = {
    "K1-slab": (lambda p, b, lo, hi, ob, out, tots:
                fused_cuda.bind_slab_step(p, b, lo, hi, ob, out, tots, N), 1),
    "K4-slab": (lambda p, b, lo, hi, ob, out, tots:
                temporal_cuda.bind_slab_sweep(p, lo, b, hi, ob, out, tots, N, NY), K),
    "K6": (lambda p, b, lo, hi, ob, out, tots:
           ghosted_cuda.bind_chunk(p, b, lo, hi, ob, out, tots, N, 2), 1),
    "K7": (lambda p, b, lo, hi, ob, out, tots:
           ca_cuda.bind_resident(p, lo, b, hi, ob, out, tots, N, NY), K),
    "K8": (lambda p, b, lo, hi, ob, out, tots:
           ca_cuda.bind_inplace(p, lo, b, hi, ob, out, tots, N, NY), K),
}


@pytest.mark.parametrize("kernel", sorted(BINDERS))
def test_cpu_binder_launches_nothing_and_refuses_another_device(kernel):
    bind, k = BINDERS[kernel]
    p = _params()
    body, lo, hi, obst, out, tots = _slab_args(k)
    launch = bind(p, body, lo, hi, obst, out, tots)
    before = dict(_build.LAUNCHES)
    launch(0)
    assert dict(_build.LAUNCHES) == before
    assert bool(tots.ne(0).any())
    meta = torch.empty_like(body, device="meta")
    with pytest.raises(ValueError):
        bind(p, meta, lo, hi, obst, out, tots)
