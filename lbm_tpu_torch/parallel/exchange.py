"""The transport of the sharded modes: the moves of one ghost exchange, and
the gathers of sums and fields, between the processes of a row mesh.

A move copies rows of one shard (a view of its buffers) into a buffer of
another.  Where both shards live in this process it is a tensor copy,
device to device where they sit on different cards, exactly what one
process does.  Where they live in two processes it is a point-to-point
message of ``torch.distributed``, the reference's MPI_Sendrecv of a halo
row (MPI/d2q9-bgk.c:674-695):

- the rows an exchange moves from one process to another travel as one
  message: every process lists the exchange's moves in the same order, so
  the sender packs them, and the receiver unpacks them, in that order.
  With two processes and one shard each, both ring neighbours are the one
  peer, and its two rows are one message each way;
- the sends and receives of an exchange are posted together
  (``dist.batch_isend_irecv``), so the two directions of a ring cannot
  deadlock, and waited for before :meth:`Exchange.finish` returns: only
  one message between two ranks is ever in flight each way, so NCCL's
  matching by order and gloo's by tag agree;
- a message leaves from, and lands in, a contiguous wire buffer bound once
  with the exchange (the rows are strided views): on the card under NCCL;
  in pinned host memory for a card under gloo, which moves only CPU
  tensors, through a contiguous buffer on the card, the device-to-host copy
  finished before the send and the host-to-device copy queued on the
  stream that reads the ghosts (a receive waits until the last copy out of
  its buffer is done); plain CPU tensors on the CPU.  Nothing is allocated
  per step.

Under NCCL the messages run on the group's stream, ordered after the
stream current at :meth:`Exchange.finish` and before what that stream runs
next, so the runner's stream joins (modes.py) order them as they order the
copies.  Under gloo the host waits for the messages.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.parallel.mesh import RowMesh


def _backend(mesh: RowMesh) -> str | None:
    if mesh.world == 1:
        return None
    import torch.distributed as dist

    return dist.get_backend()


class Exchange:
    """The moves of one exchange: ``(src shard, dst shard, src view, dst
    view)`` in global shard numbers, the views None where the shard is not
    this process's, in one order that every process of the mesh lists
    alike.  ``start()`` then ``finish()`` (or a call) runs it on the current
    streams; a runner starts it, queues work that does not read its
    buffers, then finishes it."""

    def __init__(self, mesh: RowMesh, moves):
        self.copies = []
        sends: dict[int, list] = {}
        recvs: dict[int, list] = {}
        for src, dst, src_view, dst_view in moves:
            src_rank, dst_rank = mesh.owner(src), mesh.owner(dst)
            if src_rank == dst_rank == mesh.rank:
                self.copies.append((dst_view, src_view))
            elif src_rank == mesh.rank:
                sends.setdefault(dst_rank, []).append(src_view)
            elif dst_rank == mesh.rank:
                recvs.setdefault(src_rank, []).append(dst_view)
        on_card = _backend(mesh) == "nccl"
        self.sends = [_Message(peer, views, on_card) for peer, views in sends.items()]
        self.recvs = [_Message(peer, views, on_card) for peer, views in recvs.items()]
        staged = [m for m in self.sends + self.recvs if m.stage is not None]
        # gloo moves only host tensors: a card's rows go through pinned host
        # buffers, and these events order the host against the card.
        self.host_staged = bool(staged)
        if staged:
            self.device = staged[0].stage.device
            self.packed, self.unpacked = torch.cuda.Event(), torch.cuda.Event()

    def start(self) -> None:
        """The local copies, and each message's rows into its wire buffer."""
        for dst, src in self.copies:
            dst.copy_(src)
        for m in self.sends:
            m.pack()
        if self.host_staged:
            self.packed.record(torch.cuda.current_stream(self.device))

    def finish(self) -> None:
        """The messages, one each way per peer, and each received message's
        wire buffer into its rows."""
        if not (self.sends or self.recvs):
            return
        import torch.distributed as dist

        if self.host_staged:
            self.packed.synchronize()  # the rows are in the send buffers
            self.unpacked.synchronize()  # the receive buffers were copied out
        ops = ([dist.P2POp(dist.isend, m.wire_bytes, m.peer) for m in self.sends]
               + [dist.P2POp(dist.irecv, m.wire_bytes, m.peer) for m in self.recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for m in self.recvs:
            m.unpack()
        if self.host_staged:
            self.unpacked.record(torch.cuda.current_stream(self.device))

    def __call__(self) -> None:
        self.start()
        self.finish()


class _Message:
    """The rows ``views`` (this process's, one dtype and device) that go to
    or come from ``peer`` in one exchange, in the moves' order: one
    contiguous wire buffer, each view's rows a part of it; for a card under
    gloo the parts lie in a buffer on the card (``stage``), copied to or
    from the pinned wire buffer in one plain copy that allocates nothing."""

    def __init__(self, peer: int, views: list[torch.Tensor], on_card: bool):
        self.peer, self.views = peer, views
        sizes = [v.numel() for v in views]
        dtype, device = views[0].dtype, views[0].device
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        self.parts = [part.view(v.shape) for part, v in zip(flat.split(sizes), views)]
        if device.type == "cuda" and not on_card:
            self.stage, self.wire = flat, torch.empty(sum(sizes), dtype=dtype, pin_memory=True)
        else:
            self.stage, self.wire = None, flat
        # Its bytes travel (NCCL has no int16 type; every backend has bytes).
        self.wire_bytes = self.wire.view(torch.uint8)

    def pack(self) -> None:
        for part, view in zip(self.parts, self.views):
            part.copy_(view)
        if self.stage is not None:
            self.wire.copy_(self.stage, non_blocking=True)

    def unpack(self) -> None:
        if self.stage is not None:
            self.stage.copy_(self.wire, non_blocking=True)
        for part, view in zip(self.parts, self.views):
            view.copy_(part)


def gather(mesh: RowMesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``x`` (the same shape on each), in rank order, on
    ``x``'s device: one all-gather of the group (through the host for a
    card under gloo); ``[x]`` with one process."""
    if mesh.world == 1:
        return [x]
    import torch.distributed as dist

    via_host = x.is_cuda and _backend(mesh) != "nccl"
    src = (x.cpu() if via_host else x).contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src)
    return [o.to(x.device) for o in out] if via_host else out
