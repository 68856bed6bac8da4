"""K9: the HBM-parts K-step sweep (csrc/hbm.cu, ``lbm_hbm_run``) and its
wrapper.

Replaces ``lbm_tpu/ops/hbm_pallas.py::_hbm_sweep_kernel`` (:157, entries
``make_sweep`` :272 and ``make_run_all`` :354, the plan ``_plan`` :92 and
``supports`` :133), float32: one sweep advances the whole grid K steps as
``P = ny / R`` row parts of R rows.  Each part's slab, extended K rows on
each side with periodic wrap, is swept in place in an L2 slot by K8's cell
walk (csrc/aa_inplace.cuh), and its body rows are written to the other
state buffer, so no buffer is read and written in one sweep (as B7 does).
The remainder steps of a run are K1 steps, as ``hbm_pallas.make_run_all``
does.

One cooperative launch runs the whole sweep, as B7 fuses its parts loop
into one call: part q in slot ``q % S``, each block starting part q + 1,
whose first step pulls its rows from device memory, as soon as it has
finished part q, while other blocks still sweep part q (a slot is reused
once every block has finished the part before it there); the body rows
drain to device memory through L2 behind (see the note at the top of
csrc/hbm.cu).

The part size and the slots (:func:`plan`): on Hopper a part's natural
home is the 50 MB L2, so (R, S) is the largest divisor R of ny with K <= R
and R + 2K <= ny (at most one image of the driven row in a part's slab)
whose S slots fit :data:`L2_SLOTS_BUDGET`, with S = 3 where that fits and
2 otherwise; not
the TPU's VMEM plan.  B7's other rules are not kept: ``K % 8 == 0`` exists
for 8-aligned DMA row offsets, and ``nx % 128`` for its lanes, while the
parts here are windows of the state at any row and width; its three-part
minimum fed its triple buffer, while here one part or two run in the same
launch.

Bound: the state's bytes once per sweep from device memory (plus 2K/R of
ghost rows), and per cell-step of the extended slabs 9 x 4 B read and
written in L2.

Beside the kernel:

- the plain version, :func:`run_plain`: ``fused_torch.run_sweeps``, K twin
  steps per sweep, which the kernel matches bitwise on fields; and
  :func:`run_parts_plain`, the same sweep computed as the kernel
  groups it (each part's slab K steps, the parts' |u| added in part order);
- :func:`slot_schedule`, the order of one block's loads, steps and slot
  waits, and the order of the |u| pass, which the tests hold to the
  pipeline's hazards.

Launches count in ``_build.LAUNCHES`` under ``K9``, one a sweep.  It runs
only when forced (``LBM_TEMPORAL_IMPL=hbm``, models/program.py), as in
``lbm_tpu``.  A wrapper takes the plain version only for a tensor on the
CPU.  For a CUDA tensor it launches the kernel or raises; it never falls
back (ops/_runner.py).
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import (
    _build,
    _runner,
    ca_cuda,
    fused_cuda,
    fused_torch,
    inplace_cuda,
    quant,
    resident_cuda,
    temporal_cuda,
)
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.utils.timing import span

# The L2 bytes K9's S slots may take (f32 extended slabs), K2's budget for
# its two copies (resident_cuda.L2_STATE_BUDGET).  In turns at K = 4 and 8
# (PERF.md Findings PR 14) the parts whose two slots fit it won: at 2048^2
# R = 256 (37.1 MiB at K = 4) over 128 and 64, at 4096^2 R = 128 (38.3
# MiB) over 256 (73 MiB) and 64.
L2_SLOTS_BUDGET = 42 * 2**20
SLOT_COUNTS = (3, 2)  # the plan's preference


def parts_valid(ny: int, K: int, R: int, S: int) -> bool:
    """Whether K9 can run a K-deep sweep of ny rows as parts of R rows in S
    slots: R divides ny, K <= R, R + 2K <= ny, S >= 1 (the L2 budget is not
    asked: a pinned plan may leave L2, slower, not wrong)."""
    return K >= 2 and K <= R and ny % R == 0 and R + 2 * K <= ny and S >= 1


def plan(params: LBMParams, K: int) -> tuple[int, int] | None:
    """(R, S): part rows and slots of a K-deep sweep of this grid (see the
    module note), or None when no part size maps."""
    ny, nx = params.ny, params.nx
    for r in range(ny - 2 * K, K - 1, -1):
        if not parts_valid(ny, K, r, 1):
            continue
        for s in SLOT_COUNTS:
            if s * inplace_cuda.state_bytes(r + 2 * K, nx) <= L2_SLOTS_BUDGET:
                return r, s
    return None


def supports(params: LBMParams, K: int, storage: str = "f32") -> bool:
    """Whether K9 maps a K-deep sweep of this grid: float32 state and a
    part size (:func:`plan`)."""
    quant.check_storage(storage)
    return storage == "f32" and plan(params, K) is not None


def slot_wait(q: int, S: int) -> int:
    """The parts every block must be done with before step 0 of part q
    overwrites slot ``q % S``: parts 0 .. q - S, the last of which held the
    slot (none while q < S).  The kernel counts blocks, G a part."""
    return q - S + 1 if q >= S else 0


def slot_schedule(P: int, S: int, K: int) -> tuple[list[tuple], list[tuple[int, int]]]:
    """The order in which one block of a K9 launch of P parts in S slots
    issues its events, and the order of the |u| pass (csrc/hbm.cu):
    ``("wait", q, parts)`` (step 0 of part q waits until every block is done
    with ``parts`` parts, :func:`slot_wait`), ``("load", q)`` (part q's step
    0 pulls its input rows from device memory into the slot) and ``("step",
    q, t, slot)``; the block is done with a part after its last step.  No
    other wait stands between a block's parts, so one block's load of part
    q + 1 may run while others still sweep part q.  The |u| pass is a list
    of (level, part) additions."""
    events = []
    for q in range(P):
        if q >= S:
            events.append(("wait", q, slot_wait(q, S)))
        events.append(("load", q))
        events += [("step", q, t, q % S) for t in range(K)]
    return events, [(t, q) for t in range(K) for q in range(P)]


def part_obstacles(obstacles: torch.Tensor, R: int, K: int) -> torch.Tensor:
    """(P, R + 2K, nx) uint8: part q's extended obstacle slab, rows
    [qR - K, qR + R + K) mod ny."""
    ny = obstacles.shape[0]
    rows = torch.arange(-K, R + K, device=obstacles.device)
    idx = torch.remainder(torch.arange(0, ny, R, device=obstacles.device)[:, None] + rows, ny)
    return obstacles[idx].to(torch.uint8).contiguous()


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              K: int):
    """The plain version of K9: whole sweeps of K twin steps, then single
    steps (``fused_torch.run_sweeps``)."""
    return fused_torch.run_sweeps(f, obstacles, params, num_steps, K)


def run_parts_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams,
                    num_steps: int, K: int, R: int):
    """The plain version of K9 grouped as the kernel groups it: per sweep,
    each part's slab, rows [qR - K, qR + R + K) mod ny of the state, K twin
    steps (``fused_torch.ca_sweep``), its R body rows kept, the sweep's
    per-level |u| the parts' sums added in part order; then single steps for
    ``num_steps mod K``."""
    ny = params.ny
    if not parts_valid(ny, K, R, 1):
        raise ValueError(f"{ny} rows do not split into parts of {R} rows at K={K}")
    n_sweeps, rem = divmod(num_steps, K)
    parts = []
    for _ in range(n_sweeps):
        out, tot = torch.empty_like(f), None
        for q in range(ny // R):
            rows = torch.remainder(torch.arange(q * R - K, q * R + R + K, device=f.device), ny)
            ext = f[:, rows]
            out[:, q * R:(q + 1) * R], tot_q = fused_torch.ca_sweep(
                ext[:, :K], ext[:, K:K + R], ext[:, K + R:], obstacles[rows], params, q * R, ny)
            tot = tot_q if tot is None else tot + tot_q
        f = out
        parts.append(tot)
    f, tot = fused_torch.run_steps(f, obstacles, params, rem)
    parts.append(tot)
    return f, torch.cat(parts)


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32", lib=None, rows: int | None = None,
                 slots: int | None = None):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: K9 sweeps, one launch
    each, then K1 steps for ``num_steps mod K`` (the signature of
    ``hbm_pallas.make_run_all``), inside the ranges ``lbm.sweeps.k<K>`` and
    ``lbm.tail`` (``temporal_cuda.plain_runner`` on the CPU).  Both state
    buffers, the slots, the per-part obstacle slabs and guard bytes and the
    partials (the band plan, the blocks' step counters a line apart, parts x
    K x blocks sums) are allocated here, once.  ``f0`` is not modified; on the card the returned
    state is one of the runner's buffers and stays valid until its next
    call.  ``lib`` as in ``inplace_cuda.make_run_all``; ``rows`` and
    ``slots`` pin R and S in place of :func:`plan`'s (for timing)."""
    if not supports(params, K, storage):
        raise ValueError(f"the HBM-parts sweep (K={K}, {storage}) cannot map a "
                         f"{params.ny}x{params.nx} grid")
    R, S = plan(params, K)
    R, S = rows or R, slots or S
    if not parts_valid(params.ny, K, R, S):
        raise ValueError(f"K9 cannot sweep {params.ny} rows as parts of {R} rows in {S} slots "
                         f"at K={K}")
    n_sweeps, rem = divmod(num_steps, K)

    def card(lib):
        dev = obstacles.device
        P, ext = params.ny // R, R + 2 * K
        slots = min(S, P)
        grid = _runner.cooperative_grid(lib, "lbm_hbm_grid", "K9", dev, ext, params.nx)
        shape = (9, params.ny, params.nx)
        fa = torch.empty(shape, dtype=torch.float32, device=dev)
        fb = torch.empty_like(fa)
        scratch = torch.empty((slots, 9, ext, params.nx), dtype=torch.float32, device=dev)
        gates = torch.empty((P, 2, params.nx), dtype=torch.uint8, device=dev)
        partials = resident_cuda.partials_buffer(  # the step counters and the part count
            ca_cuda.sweep_plan(ext, params.nx, K, grid), P * K, dev, counters=grid + 1)
        obst_parts = part_obstacles(obstacles, R, K)
        tail = fused_cuda.make_run_all(params, obstacles, rem) if rem else None
        omega, w1, w2 = fused_torch.step_constants(params)

        def run_all(f):
            tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if n_sweeps:
                fa.copy_(f)
                with span(f"sweeps.k{K}"):
                    for s in range(n_sweeps):
                        src, dst = (fa, fb) if s % 2 == 0 else (fb, fa)
                        _build.launch(
                            lib, "lbm_hbm_run", "K9", src.data_ptr(), dst.data_ptr(),
                            obst_parts.data_ptr(), scratch.data_ptr(), gates.data_ptr(),
                            partials.data_ptr(), tot.data_ptr() + 4 * s * K, params.ny,
                            params.nx, R, K, slots, params.accel_row, omega, w1, w2, grid,
                            stream, dev.index)
                f = fb if n_sweeps % 2 else fa
            if rem:
                with span("tail"):
                    f, tot_rem = tail(f)
                tot[n_sweeps * K:] = tot_rem
            return f, tot

        return run_all

    return _runner.card_or_plain(params, obstacles,
                                 temporal_cuda.plain_runner(params, obstacles, num_steps, K),
                                 card, lib=lib)
