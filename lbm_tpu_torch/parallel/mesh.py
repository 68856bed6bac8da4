"""The row mesh of the sharded modes: one torch device per shard.

The counterpart of ``lbm_tpu/parallel/mesh.py``.  The reference decomposes
the grid into contiguous row bands on a periodic ring of MPI ranks
(up = (r-1+P)%P, down = (r+1)%P, MPI/d2q9-bgk.c:205-211, 674-695);
``lbm_tpu`` puts the bands on a 1-D ``jax.sharding.Mesh`` that one process
drives.  Here one process drives a list of torch devices, one per shard:
on a host with several cards shard r lives on its own card, and
``--host-devices N`` makes the run's one device (the CPU, or one card)
count as N devices, as ``lbm_tpu``'s ``--host-devices`` makes N virtual CPU
devices.  Either way every shard keeps its own tensor, and its ghost rows
reach it only through the exchange (parallel/modes.py).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The shards' devices, in ring order (shard r holds rows r*nloc ...)."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device of the mesh once, in order of first use."""
        return tuple(dict.fromkeys(self.devices))


def available_devices(device: torch.device | str, host_devices: int | None = None
                      ) -> list[torch.device]:
    """The devices a run on ``device`` may shard over: ``host_devices``
    copies of ``device`` when given, else every CUDA card for a CUDA
    device, or the one CPU."""
    dev = torch.device(device)
    if host_devices is not None:
        if host_devices < 1:
            raise ValueError(f"--host-devices must be >= 1, got {host_devices}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * host_devices
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_row_mesh(num_devices: int | None, devices) -> RowMesh:
    """A 1-D mesh over the first ``num_devices`` of ``devices`` (None: all
    of them)."""
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"need at least 1 device, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices but only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return RowMesh(tuple(devices))


def ring_perms(num_shards: int):
    """Forward (to r+1) and backward (to r-1) ring permutations, the
    reference's periodic up/down neighbours (MPI/d2q9-bgk.c:210-211)."""
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    return fwd, bwd
