"""The row mesh of the sharded modes: one torch device per shard, and the
processes that hold the shards.

The counterpart of ``lbm_tpu/parallel/mesh.py``.  The reference decomposes
the grid into contiguous row bands on a periodic ring of MPI ranks
(up = (r-1+P)%P, down = (r+1)%P, MPI/d2q9-bgk.c:205-211, 674-695);
``lbm_tpu`` puts the bands on a 1-D ``jax.sharding.Mesh`` that spans the
devices of every process of ``jax.distributed``.  Here each process drives
a list of torch devices, one per shard of its own: on a host with several
cards shard r lives on its own card, and ``--host-devices N`` makes the
process's one device (the CPU, or one card) count as N devices, as
``lbm_tpu``'s ``--host-devices`` makes N virtual CPU devices.  Either way
every shard keeps its own tensor, and its ghost rows reach it only through
the exchange (parallel/modes.py, parallel/exchange.py).

With several processes (a ``torch.distributed`` process group, joined by
:func:`join`) every process holds the same number of shards, process p
the global shards p*N .. p*N + N - 1, so the ring's order is the ranks'
order; a ghost row whose two shards live in two processes travels as a
point-to-point message.  With one process the mesh is every shard.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

# Seconds a collective or a message of the process group may wait for its
# peers before it raises (a rank that died or hangs).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """This process's shards' devices, in ring order, and its place among
    the processes: local shard l is global shard ``first + l`` (shard r
    holds rows r*nloc ...)."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world: int = 1

    @property
    def local(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of the whole mesh, every process's."""
        return self.local * self.world

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * self.local

    def owner(self, shard: int) -> int:
        """The rank that holds global shard ``shard``."""
        return shard // self.local

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device of this process's shards once, in order of first use."""
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


def make_row_mesh(num_devices: int | None, devices, rank: int = 0, world: int = 1) -> RowMesh:
    """A 1-D mesh over the first ``num_devices`` of ``devices`` (None: all
    of them).  With ``world`` > 1 processes, ``devices`` are this process's
    (rank ``rank``) shards, every process holds as many, and
    ``num_devices``, when given, must be the global count."""
    devices = [torch.device(d) for d in devices]
    if world > 1:
        if num_devices is not None and num_devices != world * len(devices):
            raise ValueError(
                f"--devices {num_devices}: {world} processes x {len(devices)} shards each "
                f"(--host-devices) hold {world * len(devices)} shards")
        return RowMesh(tuple(devices), rank, world)
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"need at least 1 device, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices but only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return RowMesh(tuple(devices))


def process_layout() -> tuple[int, int]:
    """(rank, world size) of the process group this process joined, or
    (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_mesh(num_devices: int | None, device: torch.device | str,
             host_devices: int | None = None) -> RowMesh:
    """The row mesh of a run on ``device``.  One process: ``num_devices``
    of :func:`available_devices`.  In a process group: ``host_devices``
    (default 1) shards of this process's ``device`` on every process."""
    rank, world = process_layout()
    if world == 1:
        return make_row_mesh(num_devices, available_devices(device, host_devices))
    return make_row_mesh(num_devices, available_devices(device, host_devices or 1), rank, world)


@dataclasses.dataclass(frozen=True)
class Process:
    """This process's place in the group it joined, its device and the
    group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str


def join(device: str = "cuda", *, coordinator: str | None = None,
         process_id: int | None = None, num_processes: int | None = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> Process:
    """Join the process group of a multi-process run.

    The place comes from ``coordinator`` (``host:port``), ``process_id``
    and ``num_processes`` where given (every process on this host, as
    ``lbm_tpu``'s dist_smoke takes them), else from the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` and tools/pod.py set them).

    The device: the CPU only for ``device="cpu"``; else card LOCAL_RANK
    where this host has a card for every local rank, the shared card
    (LOCAL_RANK modulo the cards) otherwise; no card raises.  The backend:
    NCCL where every rank has its own card, gloo otherwise;
    ``LBM_DIST_BACKEND=nccl|gloo`` asks for one, and NCCL asked for where
    ranks share a card or run on the CPU raises: the backend is never
    switched silently."""
    import torch.distributed as dist

    env = os.environ
    if num_processes is None:
        world = int(env.get("WORLD_SIZE", "1"))
        rank = int(env.get("RANK", "0"))
        local_rank = int(env.get("LOCAL_RANK", str(rank)))
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
        addr, port = env.get("MASTER_ADDR", "127.0.0.1"), env.get("MASTER_PORT")
        if port is None:
            raise ValueError("MASTER_PORT is not set: no launcher environment to join")
    else:
        if process_id is None or coordinator is None:
            raise ValueError("an explicit group needs --coordinator, --process-id and "
                             "--num-processes")
        world, rank = num_processes, process_id
        local_rank, local_world = process_id, num_processes
        addr, _, port = coordinator.rpartition(":")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world} processes")
    asked = env.get("LBM_DIST_BACKEND", "auto").strip().lower()
    if asked not in ("auto", "nccl", "gloo"):
        raise ValueError(f"LBM_DIST_BACKEND={asked!r}; use nccl, gloo or auto")
    dev = torch.device(device)
    own_card = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device")
        cards = torch.cuda.device_count()
        own_card = cards >= local_world
        dev = torch.device("cuda", local_rank if own_card else local_rank % cards)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu")
    backend = ("nccl" if own_card else "gloo") if asked == "auto" else asked
    if backend == "nccl" and not own_card:
        where = ("the CPU" if dev.type == "cpu" else
                 f"{local_world} local ranks share {torch.cuda.device_count()} card(s)")
        raise ValueError(f"LBM_DIST_BACKEND=nccl needs a card for every rank, but {where}; "
                         "use gloo (the default there)")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    # Every rank takes part in the group's first operation (NCCL's rule for
    # the point-to-point batches that follow).
    dist.barrier(device_ids=[dev.index] if backend == "nccl" else None)
    return Process(rank, world, dev, backend)


def leave() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def ring_perms(num_shards: int):
    """Forward (to r+1) and backward (to r-1) ring permutations, the
    reference's periodic up/down neighbours (MPI/d2q9-bgk.c:210-211)."""
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    return fwd, bwd
