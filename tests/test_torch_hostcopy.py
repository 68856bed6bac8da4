"""The collate's copies to host memory (lbm_tpu_torch/utils/hostcopy.py).

On the CPU: the ring's chunk plan covers every byte of a copy once, in
order, at the edges of a chunk and at the benchmark cells' output sizes
(the plan only: nothing that size is allocated), the ring's schedule on a
fake card (the copies run at once, so a buffer reused too early shows),
and the two entry points return what ``.cpu().numpy()`` returned, byte
for byte, of the same dtype, shape and order.  On the card (``cuda``): ``fetch`` through the ring is
bitwise ``.cpu()`` at the cells' shapes, an odd size and non-contiguous
inputs, its ring is allocated once a process and device, and the entry
points' outputs on K5 and K11 are bitwise the ``.cpu()`` copies of the
same tensors.  No JAX here: the card tests run without the conftest."""

import contextlib
import types

import numpy as np
import pytest
import torch

from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import ensemble
from lbm_tpu_torch.utils import hostcopy

C = hostcopy.CHUNK_BYTES

# The benchmark cells' outputs in bytes: f (instances x 9 x ny x nx x 4)
# and the per-step sums (steps x instances x 4).
CELL_BYTES = {
    "refbox.2048.f": 9 * 2048 * 2048 * 4, "refbox.2048.sums": 8000 * 4,
    "refbox.1024.f": 9 * 1024 * 1024 * 4, "refbox.1024.sums": 20000 * 4,
    "sweep128.omega64.f": 64 * 9 * 128 * 128 * 4, "sweep128.omega64.sums": 40000 * 64 * 4,
}
SIZES = {"0": 0, "1": 1, "chunk-1": C - 1, "chunk": C, "chunk+1": C + 1, **CELL_BYTES}


@pytest.mark.parametrize("nbytes", list(SIZES.values()), ids=list(SIZES))
def test_chunks_cover_every_byte_once_in_order(nbytes):
    parts = hostcopy.chunks(nbytes)
    assert len(parts) == -(-nbytes // C)
    pos = 0
    for a, b in parts:
        assert a == pos and 0 < b - a <= C
        pos = b
    assert pos == nbytes
    assert all(b - a == C for a, b in parts[:-1])


class _FakeEvent:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.mark.parametrize("nbytes", [0, 1, 63, 64, 65, 1000, 4103])
def test_ring_copies_every_chunk_through_its_buffer_on_a_fake_card(nbytes, monkeypatch):
    """The ring's schedule, on the CPU: the card's copies run at once (a
    fake stream and events), chunks of 64 bytes, so a chunk started into a
    buffer before the host has copied the one it holds out would show."""
    monkeypatch.setattr(hostcopy, "CHUNK_BYTES", 64)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    ring = hostcopy.Ring.__new__(hostcopy.Ring)
    ring.device = torch.device("cpu")
    ring.bufs = [torch.empty(64, dtype=torch.uint8) for _ in range(2)]
    ring.stream = types.SimpleNamespace(wait_event=lambda event: None)
    ring.landed = [_FakeEvent(), _FakeEvent()]
    src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8)
    dst = torch.zeros(nbytes, dtype=torch.uint8)
    ring.copy(src, dst)
    assert torch.equal(dst, src)


def _params(n=16, steps=20):
    return LBMParams(nx=n, ny=n, max_iters=steps, reynolds_dim=10, density=0.1,
                     accel=0.005, omega=1.85)


def _mask(n=16):
    mask = np.zeros((n, n), dtype=bool)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    mask[5:7, 8:10] = True
    return mask


def _cpu_copy(src, host):
    """The collate's copy before utils/hostcopy.py."""
    return src.cpu().numpy()


def _simulate(device="cpu", n=16, steps=20, variant="torch"):
    res = driver.run_simulation(Scene(_params(n, steps), _mask(n)),
                                driver.RunConfig(variant=variant, device=device, num_devices=1))
    return res, [res.f, res.av_vels]


def _ensemble(device="cpu", n=16, steps=20, B=3):
    res = ensemble.run_ensemble(_params(n, steps), _mask(n),
                                np.linspace(1.3, 1.9, B, dtype=np.float32), device=device)
    return res, [res.f, res.av_vels, res.reynolds]


ENTRIES = {"run_simulation": _simulate, "run_ensemble": _ensemble}


def _same_arrays(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.flags.c_contiguous == w.flags.c_contiguous
        assert np.array_equal(g, w)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_cpu_outputs_are_the_cpu_copys(entry, monkeypatch):
    """On the CPU the entry points return what ``.cpu().numpy()`` gave,
    and nothing is staged or allocated for the ring."""
    before = (hostcopy.FETCH_BYTES, hostcopy.FETCH_RING_ALLOCS)
    _, got = ENTRIES[entry]()
    assert (hostcopy.FETCH_BYTES, hostcopy.FETCH_RING_ALLOCS) == before
    monkeypatch.setattr(hostcopy, "fetch", _cpu_copy)
    _, want = ENTRIES[entry]()
    _same_arrays(got, want)


def test_cpu_tensors_take_the_plain_copy():
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert hostcopy.prepare(src.shape, src.dtype, src.device) is None
    got = hostcopy.fetch(src[:, 1:], None)
    _same_arrays([got], [src[:, 1:].cpu().numpy()])


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


SHAPES = {"refbox.2048": (9, 2048, 2048), "refbox.1024": (9, 1024, 1024),
          "sweep128.omega64": (64, 9, 128, 128), "odd": (9, 1000, 1001),
          "sums": (40000, 64), "one": (1,), "empty": (0,)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_fetch_is_the_cpu_copy_on_card(cuda_device, shape):
    src = torch.randn(shape, device=cuda_device)
    want = src.cpu().numpy()
    _same_arrays([hostcopy.fetch(src, hostcopy.prepare(shape, src.dtype, cuda_device))], [want])


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["rows", "transposed", "int16"])
def test_fetch_of_a_view_is_the_cpu_copy_on_card(cuda_device, view):
    """A row slice (the sharded ``f_of``), a permuted view and another
    dtype come back C-ordered, as ``.cpu().numpy()`` gives them."""
    base = torch.randn(9, 1040, 1024, device=cuda_device)
    src = {"rows": base[:, :1000], "transposed": base[0].t(),
           "int16": (base * 1000).to(torch.int16)[:, 3:]}[view]
    want = src.cpu().numpy()
    got = hostcopy.fetch(src, hostcopy.prepare(src.shape, src.dtype, cuda_device))
    assert got.flags.c_contiguous
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.cuda
def test_the_ring_is_allocated_once_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(hostcopy, "_RINGS", {})
    monkeypatch.setattr(hostcopy, "FETCH_RING_ALLOCS", 0)
    monkeypatch.setattr(hostcopy, "FETCH_BYTES", 0)
    src = torch.randn(9, 1000, 1001, device=cuda_device)
    for calls in (1, 2, 3):
        hostcopy.fetch(src, hostcopy.prepare(src.shape, src.dtype, cuda_device))
        assert hostcopy.FETCH_RING_ALLOCS == 1
        assert hostcopy.FETCH_BYTES == calls * src.numel() * 4


@pytest.mark.cuda
def test_fetch_refuses_a_host_tensor_of_another_shape_on_card(cuda_device):
    src = torch.randn(4, 5, device=cuda_device)
    with pytest.raises(ValueError):
        hostcopy.fetch(src, torch.empty(5, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("entry,kwargs,kernel", [
    ("run_simulation", dict(n=2048, steps=10, variant="auto"), "cuda-skew"),
    ("run_ensemble", dict(n=128, steps=300, B=64), "K11"),
], ids=["K5", "K11"])
def test_entry_points_return_the_cpu_copy_on_card(cuda_device, monkeypatch, entry, kwargs,
                                                  kernel):
    """Every array an entry point fetches is bitwise ``.cpu().numpy()`` of
    the same device tensor, taken beside it."""
    real, copies = hostcopy.fetch, []

    def spy(src, host):
        want = src.cpu().numpy()
        got = real(src, host)
        copies.append((got, want))
        return got

    monkeypatch.setattr(hostcopy, "fetch", spy)
    res, _ = ENTRIES[entry](device="cuda", **kwargs)
    assert kernel in (res.variant if entry == "run_simulation" else res.kernel)
    assert len(copies) == 2
    for got, want in copies:
        _same_arrays([got], [want])
    assert any(got is res.f for got, _ in copies)  # the fetched array itself
