"""The collate's copies of a run's outputs from the card to host memory.

A run ends when its outputs (the final distributions, the per-step sums)
are numpy arrays in ordinary pageable host memory that the caller owns.
``tensor.cpu()`` gets them there through the CUDA driver's pageable path
into a host array that has only just been mapped, so every page is
faulted in during the copy while the card waits (about 2 GB/s for a
151 MB state on an H100 80GB HBM3).  Here the same bytes take two steps:

- :func:`prepare`, called by the entry points after the last launch is
  queued and before the compute bracket's synchronize: the host array is
  allocated and every page of it written (a parallel fill, which releases
  the interpreter lock), so the faults fall under the card's queued work.
  The range ``lbm.host_prepare`` marks it while a profiler records.
- :func:`fetch`, in the collate: the tensor's bytes go through a ring of
  two page-locked buffers of :data:`CHUNK_BYTES`, allocated once a process
  and device (:func:`ring`).  Chunk i goes from the card to its buffer on
  a side stream, ordered after the work queued on the tensor's stream by
  an event, while the host copies chunk i - 1 out of the other buffer into
  its slice of the prepared array.  The range ``lbm.fetch`` marks it.

The result is the same bytes, dtype, shape and C order as
``tensor.cpu().numpy()``.  No caller memory is registered or page-locked
(a caller may keep many runs' outputs), and no page-locked memory is
allocated per call.  A tensor on the CPU takes ``.cpu().numpy()``, with
no range and no copy.  The checkpoint hook and the frames and densities
of ``run_simulation`` keep ``.cpu()``: they are not the run's collate.

``FETCH_BYTES`` counts the bytes staged through the ring and
``FETCH_RING_ALLOCS`` the rings allocated (one a process and device).
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.utils.timing import span

FETCH_BYTES = 0
FETCH_RING_ALLOCS = 0

# Bytes a chunk: the size of each of the ring's two page-locked buffers.
# Timed on an H100 80GB HBM3 (700 W, PCIe 49.6 GB/s into one pinned buffer,
# 8 host threads), median of 11 in turns: the 151 MB state in 12.3 ms at
# 32 MiB, 13.9 at 16 and 17.2 at 4 (``.cpu()`` 65.7); 37.7 MB in 2.5, 2.8
# and 4.9 ms (16.0).  The host's copy out of the buffer sets the pace.
CHUNK_BYTES = 32 << 20

_RINGS: dict = {}  # ring(): one a process and device


def chunks(nbytes: int) -> list[tuple[int, int]]:
    """The byte ranges ``[start, stop)`` of a copy of ``nbytes`` in chunks
    of :data:`CHUNK_BYTES`, in order; the last one may be shorter."""
    return [(a, min(a + CHUNK_BYTES, nbytes)) for a in range(0, nbytes, CHUNK_BYTES)]


class Ring:
    """Two page-locked buffers of :data:`CHUNK_BYTES` and a side stream on
    one card, which copy a device tensor's bytes into a host tensor."""

    def __init__(self, device: torch.device):
        global FETCH_RING_ALLOCS
        self.device = device
        self.bufs = [torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.stream = torch.cuda.Stream(device)
        self.landed = [torch.cuda.Event(), torch.cuda.Event()]
        FETCH_RING_ALLOCS += 1

    def copy(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """``dst`` (contiguous, on the host) <- ``src`` (contiguous, on this
        card), byte for byte, once the work queued on ``src``'s stream ends."""
        src_b, dst_b = src.view(-1).view(torch.uint8), dst.view(-1).view(torch.uint8)
        parts = chunks(src_b.numel())
        with torch.cuda.device(self.device):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self.stream.wait_event(ready)

            def start(i: int) -> None:
                a, b = parts[i]
                with torch.cuda.stream(self.stream):
                    self.bufs[i % 2][:b - a].copy_(src_b[a:b], non_blocking=True)
                self.landed[i % 2].record(self.stream)

            for i in range(min(2, len(parts))):
                start(i)
            for i, (a, b) in enumerate(parts):
                self.landed[i % 2].synchronize()
                dst_b[a:b].copy_(self.bufs[i % 2][:b - a])
                if i + 2 < len(parts):
                    start(i + 2)


def ring(device: torch.device) -> Ring:
    """The process's ring on ``device``, allocated at its first use."""
    if device not in _RINGS:
        _RINGS[device] = Ring(device)
    return _RINGS[device]


def prepare(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor | None:
    """A host tensor of ``shape`` and ``dtype`` with every page written,
    for :func:`fetch` of an output on ``device``; None for a CPU output,
    which needs none."""
    if device.type != "cuda":
        return None
    with span("host_prepare"):
        return torch.empty(tuple(shape), dtype=dtype).zero_()


def fetch(src: torch.Tensor, host: torch.Tensor | None) -> np.ndarray:
    """``src.cpu().numpy()``, bitwise: for a card tensor through the ring
    into ``host``, from :func:`prepare` (which gives None for a CPU one)."""
    global FETCH_BYTES
    if src.device.type != "cuda":
        return src.cpu().numpy()
    with span("fetch"):
        if host.shape != src.shape or host.dtype != src.dtype or not host.is_contiguous():
            raise ValueError(f"host tensor {tuple(host.shape)} {host.dtype} does not take "
                             f"{tuple(src.shape)} {src.dtype}")
        src = src.contiguous()
        ring(src.device).copy(src, host)
        FETCH_BYTES += src.numel() * src.element_size()
        return host.numpy()
