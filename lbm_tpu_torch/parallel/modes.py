"""Row-sharded step programs: the sync, overlap, async, async-k, chunked
and ca disciplines.

The counterpart of ``lbm_tpu/parallel/modes.py::build_sharded_program``
(:886).  The reference decomposes the grid into row bands
with one halo row per side and exchanges the halos under three disciplines
(blocking Sendrecv, Isend/Irecv + Waitall, stale-halo Testall,
MPI*/d2q9-bgk.c); ``lbm_tpu`` runs them as a ``shard_map`` whose halos ride
``ppermute``.  Here each shard is its own ``(9, nloc, nx)`` tensor on its
own device of a :class:`~lbm_tpu_torch.parallel.mesh.RowMesh`, and the
exchange is a copy of the neighbours' edge rows into the shard's own ghost
buffers (device to device where the shards sit on different cards):

- **sync**: exchange, then every shard's slab step;
- **overlap**: the exchange on a side CUDA stream while the interior rows
  1..nloc-2 run on the main stream, joined by events, then the two
  boundary rows; fields equal sync's bitwise;
- **async** (staleness k >= 1; ``async-k`` is k = 2 by default): the
  exchange that delivers the ghosts of step t + k is issued at step t on
  the side stream, while step t computes with the ghosts issued at step
  t - k (deterministic bounded staleness, ``lbm_tpu``'s step_async /
  step_async_k);
- **chunked** (k): k steps with the ghosts frozen, then one exchange.  The
  chunk runs as one K6 launch per shard (ops/ghosted_cuda.py) where K6 maps
  (f32, no open seam, two copies of the shard within the L2 budget), else
  as k K1-slab steps, as ``lbm_tpu`` runs its ghosted chunk kernel or a
  loop of slab steps;
- **ca** (exact communication-avoiding, K = ``ca_depth(staleness)``): every
  K steps each shard receives the K edge rows of each neighbour into its
  own ghost buffers, then advances K steps in one sweep of its
  ghost-extended slab that recomputes the ghosts' evolution locally; the
  fields equal sync's bitwise.  One engine sweeps all shards
  (:func:`ca_engine_choice`): K4-slab (ops/temporal_cuda.py), K7 or K8
  (ops/ca_cuda.py; K8 split into sub-slabs where a shard is too tall for
  L2).  A run whose step count is not a multiple of K ends in a sync tail
  (models/driver.py).

Every slab step is one K1-slab launch (ops/fused_cuda.py) on the ``cuda``
backend, or the plain slab step (``fused_torch.fused_step_slab``) on the
``torch`` backend; the cuda backend's wrappers run their plain versions on
CPU tensors.  Body, ghosts and output are windows of persistent buffers,
bound once per runner, so overlap's sub-slabs need no concatenation.

Streams: a buffer written on one stream and read on the other is ordered
by ``wait_stream`` (an event) in both directions, and every runner call
ends by joining the side stream into the main one, so no side-stream work
is pending when its buffers could be freed.

|u|: each slab step leaves its tot_u in a per-shard buffer; a step's total
is the per-shard sums added in shard order (overlap's per shard as
``(interior + bottom) + top``, modes.py:1174).  No atomics.

Processes (``lbm_tpu``'s multi-controller form over ``jax.distributed``,
:1056, :1270): the mesh's shards may be spread over the processes of a
``torch.distributed`` group (parallel/mesh.py), each process stepping its
own.  Every move of an exchange whose two shards live in two processes is
a message (parallel/exchange.py): the ring, ca's K rows and the open-seam
pad refresh, whose shards (the first and the last) live in the first and
the last process.  The schedules do not change: overlap's interiors and
async's step are queued before the host waits for the messages.  The
per-step sums are gathered once per call and added in shard order on every
process, and ``f_of`` gathers the rows, so every process holds the
one-process result bitwise.

Seam padding (an ny that the shard count does not divide) is ``lbm_tpu``'s:
walled seams get blocked rows at rest; open seams get live clones of the
global first rows, refreshed after every step (frozen within a chunk), and
shard 0's lower ghost comes from the last real row.  Lane padding is not
ported: the kernels take any nx.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.models.program import StepProgram, u_mag_fn
from lbm_tpu_torch.ops import _runner, ca_cuda, fused_cuda, ghosted_cuda, quant, temporal_cuda
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.parallel import mesh as mesh_lib
from lbm_tpu_torch.parallel.exchange import Exchange, gather

# Per-variant staleness defaults (halo age / chunk length / ca exchange
# depth), lbm_tpu's modes.py:47.
STALENESS_DEFAULTS = {"async": 1, "async-k": 2, "chunked": 2, "ca": 4}

MODES = ("sync", "overlap", "async", "chunked", "ca")
CA_ENGINES = ("slab", "resident", "inplace")

# lbm_tpu's backend names carry over: jnp -> torch, pallas -> cuda.
_BACKENDS = {"torch": "torch", "cuda": "cuda", "jnp": "torch", "pallas": "cuda"}


def open_seam_pad(obstacles: np.ndarray, num_shards: int) -> int:
    """Rows of open-seam padding a scene needs on this mesh: 0 when the
    shard count divides ny, or when both seam rows are walls, so that
    blocked padding rows can be inserted without touching the flow
    (``lbm_tpu``'s modes.py:135)."""
    pad = (-obstacles.shape[0]) % num_shards
    if not pad:
        return 0
    walled = bool(obstacles[0].all()) and bool(obstacles[-1].all())
    return 0 if walled else pad


def _extended_obstacle_slabs(obstacles: np.ndarray, num_shards: int,
                             depth: int = 1) -> np.ndarray:
    """Per-shard obstacle slabs with ``depth`` periodically wrapped ghost
    rows on each side, (R, nloc + 2 depth, nx): one for the slab step, which
    injects ghost rows too (``lbm_tpu``'s modes.py:871), K for ca's sweeps
    (:1262-1269)."""
    ny, _ = obstacles.shape
    nloc = ny // num_shards
    return np.stack([obstacles[np.arange(r * nloc - depth, r * nloc + nloc + depth) % ny]
                     for r in range(num_shards)])


def sharded_cuda_supported(ny: int, nx: int, num_shards: int) -> bool:
    """Whether the cuda backend maps this sharded layout (``lbm_tpu``'s
    ``sharded_pallas_supported``): K1-slab takes any width and any shard
    height, so only the two rows per shard that every mode needs remain."""
    return (ny + (-ny) % num_shards) // num_shards >= 2


def ca_depth(staleness: int) -> int:
    """Exchange depth K of the ca mode for a ``--staleness`` value (at least
    2: a 1-deep exchange is sync), ``lbm_tpu``'s modes.py:50."""
    return max(2, staleness)


# The deeper ca depth of shards that K7 or K8 sweeps unsplit.
CA_DEEP_K = 8


def ca_default_staleness(params: LBMParams, obstacles: np.ndarray, num_shards: int,
                         storage: str = "f32") -> int:
    """The ca depth a run takes without ``--staleness`` (``lbm_tpu``'s
    :56): :data:`CA_DEEP_K` = 8 where the engine ca takes at K = 8 is K7 or
    K8 unsplit (the shard's extended slab fits L2), else
    ``STALENESS_DEFAULTS["ca"]`` = 4.

    From the ca engines timed in turns on an NVIDIA H100 80GB HBM3 at 700 W
    (PERF.md, Findings; ``tools/kernel_times.py --ca``): K = 8 against K = 4,
    K7 3.501 against 4.084 us/step on a 64x1024 shard and 6.450 against
    7.202 on 256x1024 (the redesigned K7); K8 4.145 against 4.322 and
    7.900 against 8.017 (int16 8.462 against 8.410); and a deeper sweep
    halves the exchanges, the host's share of a step; K4-slab, which takes
    the shards K7 and K8 cannot hold, ran K = 4 faster (1024x4096: 92.4
    against 120.2).  ``lbm_tpu``'s K = 8 from 96 rows is a TPU measurement."""
    ny = obstacles.shape[0]
    ny_pad = ny + (-ny) % num_shards
    engine = ca_engine_of(params, obstacles, num_shards, CA_DEEP_K, storage)
    if engine == "resident" or (
            engine == "inplace" and ca_cuda.inplace_parts(
                ny_pad // num_shards, obstacles.shape[1], CA_DEEP_K, ny_pad, storage) == 1):
        return CA_DEEP_K
    return STALENESS_DEFAULTS["ca"]


def ca_engine_choice(params: LBMParams, nloc: int, nx: int, K: int, *, storage: str = "f32",
                     backend: str = "cuda", ny_global: int | None = None) -> str | None:
    """Which K-sweep engine backs the ca mode for nloc x nx shards at depth
    K (``lbm_tpu``'s :243): ``'slab'`` (K4-slab), ``'resident'`` (K7, f32),
    ``'inplace'`` (K8, split into sub-slabs where the shard is too tall),
    or None when none maps (ca unsupported); only the ``cuda`` backend has
    engines.  ``ny_global`` is the grid's row count after seam padding
    (K8's one-image rule), by default ``params.ny``.

    ``LBM_CA_ENGINE`` forces one (``slab`` / ``resident`` / ``inplace``;
    None where it cannot map, so the build raises: never another engine).

    Auto, from the engines timed in turns on an NVIDIA H100 80GB HBM3 at
    700 W (PERF.md, Findings; ``lbm_tpu``'s table, :269-281, is a TPU
    measurement):

    - f32: where the whole shard's extended slab fits L2 for K8, K7 where
      its two copies fit too (the redesigned K7, at K=8, median of
      7 rounds x 5 placements: 64x1024 3.501 us/step against K8 3.886 and
      K4-slab 6.065; 256x1024 6.450 against K8 6.769 and K4-slab 11.255;
      golden ca-8 over 4 shards 33.2-33.4k MLUPS on K7 against 30.6-30.9k
      on K8, byte-identical), else K8; else K4-slab (1024x4096 K=4: 92.4
      against K8 split into 8 sub-slabs 128.7), else K8 split, else K7;
    - int16: K8-i16 wherever it maps, split or not, else K4-slab-i16.  It
      quantizes every step, as the single-device default does (int16 is not
      swept by default, ``temporal_cuda.pick_k``), so ca-i16 equals sync-i16
      bitwise; it was also the faster where it fits (256x1024 K=4: 8.410
      against 8.881), not on 1024x4096 (116.5 split in 4 against 96.2)."""
    if _BACKENDS.get(backend) != "cuda":
        return None
    ny_global = params.ny if ny_global is None else ny_global
    ok = {"slab": temporal_cuda.supports_shard(nloc, nx, K),
          "resident": storage == "f32" and ca_cuda.supports_resident(nloc, nx, K),
          "inplace": ca_cuda.inplace_parts(nloc, nx, K, ny_global, storage) is not None}
    forced = os.environ.get("LBM_CA_ENGINE", "auto").strip().lower()
    if forced != "auto":
        if forced not in CA_ENGINES:
            raise ValueError(f"LBM_CA_ENGINE={forced!r}; use one of {CA_ENGINES} or auto")
        return forced if ok[forced] else None
    if storage == "i16":
        order = ("inplace", "slab")
    elif ca_cuda.inplace_parts(nloc, nx, K, ny_global, storage) == 1:
        order = ("resident", "inplace")
    else:
        order = ("slab", "inplace", "resident")
    return next((e for e in order if ok[e]), None)


def ca_parts(nloc: int, nx: int, K: int, ny_global: int, storage: str = "f32") -> int:
    """Sub-slabs of the in-place engine: ``LBM_CA_PARTS`` when set (any
    count whose sub-slabs K8 can run, ``ca_cuda.parts_valid``; else it
    raises), else the smallest count whose sub-slabs fit L2
    (``ca_cuda.inplace_parts``: 1 wherever the whole shard fits)."""
    forced = os.environ.get("LBM_CA_PARTS", "").strip()
    if forced:
        parts = int(forced)
        if not ca_cuda.parts_valid(nloc, nx, K, ny_global, parts):
            raise ValueError(f"LBM_CA_PARTS={parts} cannot split {nloc}-row shards at depth "
                             f"K={K} (sub-slabs of at least K rows, ext <= {ny_global})")
        return parts
    parts = ca_cuda.inplace_parts(nloc, nx, K, ny_global, storage)
    if parts is None:
        raise ValueError(f"the in-place ca engine cannot map {nloc}x{nx} shards at K={K}")
    return parts


def ca_engine_of(params: LBMParams, obstacles: np.ndarray, num_shards: int,
                 staleness: int = STALENESS_DEFAULTS["ca"], storage: str = "f32",
                 backend: str | None = None) -> str | None:
    """The engine a ca build over ``num_shards`` shards at ``staleness``
    would take, or None where ca does not map (``lbm_tpu``'s :610), exactly
    the build's gate: no open seam, at least two rows per shard, and an
    engine that maps at ``ca_depth(staleness)`` on the padded shard
    (:func:`ca_engine_choice`, ``LBM_CA_ENGINE`` included)."""
    ny, nx = obstacles.shape
    if open_seam_pad(obstacles, num_shards):
        return None
    ny_pad = ny + (-ny) % num_shards
    nloc = ny_pad // num_shards
    if nloc < 2:
        return None
    return ca_engine_choice(params, nloc, nx, ca_depth(staleness), storage=storage,
                            backend=backend or "cuda", ny_global=ny_pad)


def ca_supported(params: LBMParams, obstacles: np.ndarray, num_shards: int,
                 staleness: int = STALENESS_DEFAULTS["ca"], storage: str = "f32") -> bool:
    """Whether the ca mode maps this scene over ``num_shards`` shards
    (:func:`ca_engine_of`)."""
    return ca_engine_of(params, obstacles, num_shards, staleness, storage) is not None


def ca_decomposes_per_step(engine: str | None, storage: str) -> bool:
    """Whether a ca run may be observed per step (``--debug``, and frames
    whose segments end off a sweep boundary) through its sync schedule.

    f32: always; ca's fields equal sync's bitwise.  int16: only where the
    engine is K8-i16 (``inplace``), which quantizes every step, as sync-i16
    does, so the two are bitwise equal (PERF.md, Findings on ca).  K4-slab-i16
    (``slab``) quantizes once per sweep, so its sync decomposition would
    trace a different trajectory: refused, as ``lbm_tpu`` refuses every
    int16 ca there (driver.py:163-168, 394-402, 856-868)."""
    return storage == "f32" or engine == "inplace"


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """What a sharded build of a scene takes, before any buffer exists:
    :func:`plan_sharded`'s answer, which :func:`build_sharded_program` and
    the execution plan (models/plan.py) both read."""

    backend: str  # "cuda" or "torch"
    ny: int  # rows of the grid, seam padding included
    nloc: int  # rows per shard
    open_pad: int  # rows of open-seam padding (0: none, or walled)
    stale_fraction: float  # async / chunked: the stale-row model's exposure, else 0
    spc: int  # steps per call: the chunk (chunked), K (ca), else 1
    label: str  # the program's variant: mode, -k or -K, -i16
    k6: bool = False  # chunked through K6
    K: int = 0  # ca: exchange depth
    engine: str | None = None  # ca: K-sweep engine (ca_engine_choice)
    parts: int = 1  # ca on the in-place engine: sub-slabs


def plan_sharded(params: LBMParams, obstacles: np.ndarray, num_shards: int, mode: str = "sync",
                 staleness: int = 1, backend: str | None = None, storage: str = "f32",
                 device_type: str = "cuda") -> ShardedPlan:
    """The choices of a sharded build over ``num_shards`` shards of
    ``device_type`` devices, arguments as :func:`build_sharded_program`,
    which calls it: backend, seam padding, the ca engine and its sub-slabs,
    K6 for chunked, the stale-row exposure and the variant the program
    reports.  Raises the build's refusals; allocates nothing."""
    ny, nx = obstacles.shape
    R = num_shards
    quant.check_storage(storage)
    if mode not in MODES:
        raise ValueError(f"unknown sharded mode {mode!r}; use one of {MODES}")
    if staleness < 1:
        raise ValueError("staleness must be >= 1")
    if backend is None:
        backend = ("cuda" if (device_type == "cuda" or storage == "i16" or mode == "ca")
                   and sharded_cuda_supported(ny, nx, R) else "torch")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use 'torch' or 'cuda'")
    backend = _BACKENDS[backend]
    if storage == "i16" and backend != "cuda":
        raise ValueError(f"storage 'i16' requires the cuda backend, got {backend!r}")
    open_pad = open_seam_pad(obstacles, R)
    ny_pad = ny + (-ny) % R
    nloc = ny_pad // R
    if nloc < 2:
        raise ValueError(f"need at least 2 rows per shard, got {nloc}")
    if open_pad and open_pad > nloc - 1:
        raise ValueError(
            f"ny={ny} over {R} shards needs {open_pad} open-seam padding rows but "
            f"shards have only {nloc} rows; choose fewer devices")
    K, engine, parts = 0, None, 1
    if mode == "ca":
        # modes.py:1010-1034: walled seam padding stays, open seams go.
        K = ca_depth(staleness)
        if open_pad:
            raise ValueError("ca mode does not support open-seam row padding; use a shard count "
                             "that divides ny, or the sync/overlap variants")
        if backend != "cuda":
            raise ValueError(f"ca mode runs on the cuda backend's K-sweep engines, got {backend!r}")
        engine = ca_engine_choice(params, nloc, nx, K, storage=storage, backend=backend,
                                  ny_global=ny_pad)
        if engine is None:
            raise ValueError(f"ca mode needs a K-sweep engine (K4-slab, K7 or K8) that maps "
                             f"{nloc}x{nx} shards at depth K={K}"
                             + (f" with LBM_CA_ENGINE={os.environ['LBM_CA_ENGINE']}"
                                if os.environ.get("LBM_CA_ENGINE") else "")
                             + "; use sync/overlap, fewer devices or a smaller staleness")
        if engine == "inplace":
            parts = ca_parts(nloc, nx, K, ny_pad, storage)
    stale_fraction = 0.0
    if mode in ("async", "chunked"):
        # The stale-row model (modes.py:1447-1466): 1.6% stale rows -> ~0.15%
        # av_vels deviation, ~6% -> ~1%.  Chunked ghosts age 1..k.
        age = (staleness + 1) / 2 if mode == "chunked" else staleness
        stale_fraction = 2.0 * R / ny_pad * age
    k6 = (backend == "cuda" and mode == "chunked" and storage == "f32" and not open_pad
          and ghosted_cuda.supports_shard(nloc, nx))
    # ca reports its effective depth (modes.py:1566-1577).
    label = mode + (f"-{K}" if mode == "ca" else
                    f"-{staleness}" if mode in ("async", "chunked") and staleness > 1 else "")
    return ShardedPlan(backend=backend, ny=ny_pad, nloc=nloc, open_pad=open_pad,
                       stale_fraction=stale_fraction,
                       spc={"chunked": staleness, "ca": K}.get(mode, 1),
                       label=label + ("-i16" if storage == "i16" else ""), k6=k6, K=K,
                       engine=engine, parts=parts)


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """The state of a sharded program: per shard its (9, nloc, nx) body and,
    for async and chunked, its ghost queue (Q, 2, 9, 1, nx), entry 0 the
    next to be consumed, [q, 0] the row below the shard and [q, 1] the row
    above (Q = the staleness for async, 1 for chunked)."""

    f: tuple[torch.Tensor, ...]
    ghosts: tuple[torch.Tensor, ...] | None = None

    def clone(self) -> "ShardedState":
        return ShardedState(tuple(x.clone() for x in self.f),
                            None if self.ghosts is None else tuple(g.clone() for g in self.ghosts))


@dataclasses.dataclass(frozen=True)
class _Layout:
    """What every runner of one program shares."""

    params: LBMParams
    mesh: mesh_lib.RowMesh
    mode: str
    staleness: int
    backend: str
    storage: str
    ny: int  # rows of the grid, seam padding included
    nloc: int
    nx: int
    open_pad: int
    obst: tuple[torch.Tensor, ...]  # per shard (nloc + 2, nx) bool
    k6: bool  # chunked through K6
    # ca only: depth, engine, sub-slabs of the in-place engine, and per
    # shard the (nloc + 2K, nx) extended obstacle slab.
    K: int = 0
    engine: str | None = None
    parts: int = 1
    ca_obst: tuple[torch.Tensor, ...] = ()

    @property
    def queue(self) -> int:
        """Ghost queue depth of the state (0: the state carries no ghosts)."""
        return {"async": self.staleness, "chunked": 1}.get(self.mode, 0)

    def lo_send_row(self, r: int) -> int:
        """The row shard r sends as the ghost below shard r + 1: its last
        row, or the last real row above the open-seam pads (modes.py:1109)."""
        last = self.mesh.size - 1
        return self.nloc - self.open_pad - 1 if self.open_pad and r == last else self.nloc - 1

    def at(self, shard: int, view):
        """``view(l)`` for global shard ``shard`` when it is this process's
        local shard l, else None (a view of another process's shard)."""
        local = shard - self.mesh.first
        return view(local) if 0 <= local < self.mesh.local else None

    def ring_moves(self, src_rows, dst_lo, dst_hi):
        """The moves of the one-row ring exchange (modes.py:1101-1120): each
        shard's ``src_rows(l, row)`` to ``dst_lo(l)`` of the shard above
        (the row below it) and ``dst_hi(l)`` of the shard below, forward
        moves first, in global shard order."""
        fwd, bwd = mesh_lib.ring_perms(self.mesh.size)
        moves = []
        for src, dst in fwd:
            row = self.lo_send_row(src)
            moves.append((src, dst, self.at(src, lambda l: src_rows(l, row)),
                          self.at(dst, dst_lo)))
        for src, dst in bwd:
            moves.append((src, dst, self.at(src, lambda l: src_rows(l, 0)),
                          self.at(dst, dst_hi)))
        return moves

    def edges(self, f):
        """The ring exchange of this process's shards ``f``: per shard (row
        below, row above) as fresh (9, 1, nx) tensors on the shard's
        device."""
        lo = [torch.empty((9, 1, self.nx), dtype=x.dtype, device=x.device) for x in f]
        hi = [torch.empty_like(x) for x in lo]
        Exchange(self.mesh, self.ring_moves(lambda l, row: f[l][:, row:row + 1],
                                            lo.__getitem__, hi.__getitem__))()
        return list(zip(lo, hi))


class _Runner:
    """Persistent buffers, bound launches and the schedule of one program
    for ``num_steps`` steps, on this process's shards (indexed locally:
    shard l is the mesh's global shard ``first + l``).  ``kind`` is the
    program's mode, or ``inner`` (one frozen-ghost step) / ``exchange``
    (the ghost exchange alone), the chunked mode's two primitives.  ca's
    ghost buffers hold K rows per side (``C[l][0]`` below the shard,
    ``C[l][1]`` above).  Every exchange is an :class:`Exchange`, bound once:
    copies between this process's shards, messages to and from the other
    processes' (parallel/exchange.py).  A call takes a :class:`ShardedState`
    (not modified) and returns (state, tot_us (num_steps,)); the returned
    state lives in the runner's buffers until its next call."""

    def __init__(self, lay: _Layout, num_steps: int, kind: str):
        self.lay, self.n, self.kind = lay, num_steps, kind
        nloc, nx = lay.nloc, lay.nx
        dtype = _runner.STATE_DTYPES[lay.storage]
        devs = lay.mesh.devices
        self.slots = lay.queue + 1 if lay.mode == "async" else 1
        self.F = [[torch.empty((9, nloc, nx), dtype=dtype, device=d) for _ in range(2)]
                  for d in devs]
        self.G = [torch.empty((self.slots, 2, 9, 1, nx), dtype=dtype, device=d) for d in devs]
        self.C = ([torch.empty((2, 9, lay.K, nx), dtype=dtype, device=d) for d in devs]
                  if lay.mode == "ca" else [])
        self.T = [torch.zeros((3, max(num_steps, 1)), dtype=torch.float32, device=d)
                  for d in devs]
        cuda_devs = [d for d in lay.mesh.distinct if d.type == "cuda"]
        self.main = {d: torch.cuda.current_stream(d) for d in cuda_devs}
        self.side = ({d: torch.cuda.Stream(d) for d in cuda_devs}
                     if lay.mode in ("overlap", "async") and kind == lay.mode else {})
        self._bound: dict = {}
        self.p, self.h = 0, 0

    # --- bound launches and exchanges, built at first use ----------------

    def _bind(self, key, make):
        if key not in self._bound:
            self._bound[key] = make()
        return self._bound[key]

    def _slab(self, l, body, lo, hi, obst, out, tot_row, row_offset):
        lay = self.lay
        bind = fused_cuda.bind_slab_step if lay.backend == "cuda" else fused_cuda.bind_slab_plain
        return bind(lay.params, body, lo, hi, obst, out, self.T[l][tot_row], row_offset,
                    lay.storage)

    def _offset(self, l):
        """The first row of local shard l in the grid."""
        return (self.lay.mesh.first + l) * self.lay.nloc

    def _full(self, l, p, s):
        """Shard l's whole-slab step from buffer p with ghost slot s."""
        def make():
            F, G = self.F[l], self.G[l]
            return self._slab(l, F[p], G[s, 0], G[s, 1], self.lay.obst[l], F[1 - p], 0,
                              self._offset(l))
        return self._bind(("full", l, p, s), make)

    def _overlap_parts(self, l, p):
        """Shard l's interior (rows 1..nloc-2, None for two-row shards),
        bottom and top sub-slab steps from buffer p (modes.py:1155-1174)."""
        def make():
            F, G, ob = self.F[l], self.G[l], self.lay.obst[l]
            src, dst, off = F[p], F[1 - p], self._offset(l)
            interior = (self._slab(l, src[:, 1:-1], src[:, :1], src[:, -1:], ob[1:-1],
                                   dst[:, 1:-1], 0, off + 1) if self.lay.nloc > 2 else None)
            bottom = self._slab(l, src[:, :1], G[0, 0], src[:, 1:2], ob[:3], dst[:, :1], 1, off)
            top = self._slab(l, src[:, -1:], src[:, -2:-1], G[0, 1], ob[-3:], dst[:, -1:], 2,
                             off + self.lay.nloc - 1)
            return interior, bottom, top
        return self._bind(("overlap", l, p), make)

    def _k6(self, l, p):
        def make():
            F, G = self.F[l], self.G[l]
            return ghosted_cuda.bind_chunk(self.lay.params, F[p], G[0, 0], G[0, 1],
                                           self.lay.obst[l], F[1 - p], self.T[l][0],
                                           self._offset(l), self.lay.staleness)
        return self._bind(("k6", l, p), make)

    def _ca_sweep(self, l, p):
        """Shard l's engine launches of one ca sweep from buffer p: one, or
        one per sub-slab of the in-place engine (modes.py:1296-1331)."""
        def make():
            lay = self.lay
            lo, hi = self.C[l]
            return ca_cuda.bind_sweep(lay.engine, lay.params, lo, self.F[l][p], hi,
                                      lay.ca_obst[l], self.F[l][1 - p], self.T[l][0],
                                      self._offset(l), lay.ny, lay.storage, lay.parts)
        return self._bind(("ca", l, p), make)

    def _ca_ring(self, p):
        """ca's exchange from buffer p: each shard's last K rows to the
        shard above, its first K rows to the shard below (modes.py:1284-1287),
        one move each."""
        def make():
            lay = self.lay
            fwd, bwd = mesh_lib.ring_perms(lay.mesh.size)
            K, nloc = lay.K, lay.nloc
            return Exchange(lay.mesh, [
                (src, dst, lay.at(src, lambda l: self.F[l][p][:, nloc - K:]),
                 lay.at(dst, lambda l: self.C[l][0])) for src, dst in fwd] + [
                (src, dst, lay.at(src, lambda l: self.F[l][p][:, :K]),
                 lay.at(dst, lambda l: self.C[l][1])) for src, dst in bwd])
        return self._bind(("ca-exchange", p), make)

    def _ring(self, p, s):
        """The exchange from buffer p into ghost slot s (modes.py:1101-1120)."""
        def make():
            return Exchange(self.lay.mesh, self.lay.ring_moves(
                lambda l, row: self.F[l][p][:, row:row + 1],
                lambda l: self.G[l][s, 0], lambda l: self.G[l][s, 1]))
        return self._bind(("exchange", p, s), make)

    def _pads(self, p, what):
        """Open-seam pad moves on buffer p: ``refresh`` clones the global
        first rows (shard 0's) into the last shard's pads (modes.py:1122-1137),
        a message where the two shards live in two processes; ``freeze``
        copies the last shard's pads of buffer p over those of the other
        buffer, keeping them at their chunk-start values (modes.py:1351)."""
        def make():
            lay = self.lay
            pad, last = lay.open_pad, lay.mesh.size - 1
            if not pad:
                return Exchange(lay.mesh, [])
            cut = lay.nloc - pad
            if what == "refresh":
                move = (0, last, lay.at(0, lambda l: self.F[l][p][:, :pad]),
                        lay.at(last, lambda l: self.F[l][p][:, cut:]))
            else:
                move = (last, last, lay.at(last, lambda l: self.F[l][p][:, cut:]),
                        lay.at(last, lambda l: self.F[l][1 - p][:, cut:]))
            return Exchange(lay.mesh, [move])
        return self._bind((what, p), make)

    # --- streams -----------------------------------------------------------

    def _side_waits_main(self):
        for d, s in self.side.items():
            s.wait_stream(self.main[d])

    def _main_waits_side(self):
        for d, s in self.side.items():
            self.main[d].wait_stream(s)

    def _on_side(self):
        stack = contextlib.ExitStack()
        for s in self.side.values():
            stack.enter_context(torch.cuda.stream(s))
        return stack

    # --- the schedules -------------------------------------------------------

    def _step_sync(self, t):
        p = self.p
        self._ring(p, 0)()
        for l in range(self.lay.mesh.local):
            self._full(l, p, 0)(t)
        self._pads(1 - p, "refresh")()
        self.p = 1 - p

    def _step_overlap(self, t):
        p = self.p
        ring = self._ring(p, 0)
        self._side_waits_main()
        with self._on_side():
            ring.start()
        parts = [self._overlap_parts(l, p) for l in range(self.lay.mesh.local)]
        for interior, _, _ in parts:
            if interior is not None:
                interior(t)
        with self._on_side():
            ring.finish()  # the messages, while the interiors run
        self._main_waits_side()
        for _, bottom, top in parts:
            bottom(t)
            top(t)
        self._pads(1 - p, "refresh")()
        self.p = 1 - p

    def _step_async(self, t):
        p, h, S = self.p, self.h, self.slots
        ring = self._ring(p, (h + S - 1) % S)
        self._main_waits_side()  # the ghosts issued at the previous step
        self._side_waits_main()  # the state they are cut from, and the slot's last reader
        with self._on_side():
            ring.start()
        for l in range(self.lay.mesh.local):
            self._full(l, p, h)(t)
        with self._on_side():
            ring.finish()  # the messages, while the step runs
        self._pads(1 - p, "refresh")()
        self.p, self.h = 1 - p, (h + 1) % S

    def _step_ca(self, t0):
        p = self.p
        self._ca_ring(p)()
        for l in range(self.lay.mesh.local):
            for launch in self._ca_sweep(l, p):
                launch(t0)
        self.p = 1 - p

    def _inner(self, t):
        p = self.p
        for l in range(self.lay.mesh.local):
            self._full(l, p, 0)(t)
        self._pads(p, "freeze")()
        self.p = 1 - p

    def _exchange(self):
        self._ring(self.p, 0)()
        self._pads(self.p, "refresh")()

    def _chunk(self, t0):
        if self.lay.k6:
            for l in range(self.lay.mesh.local):
                self._k6(l, self.p)(t0)
            if self.lay.staleness % 2:  # K6 ends in F[1 - p] for an odd chunk, in F[p] else
                self.p = 1 - self.p
        else:
            for j in range(self.lay.staleness):
                self._inner(t0 + j)
        self._exchange()

    # --- a call ---------------------------------------------------------------

    def _load(self, state: ShardedState):
        for l, x in enumerate(state.f):
            self.F[l][0].copy_(x)
        if self.lay.queue:
            for l, g in enumerate(state.ghosts):
                self.G[l][:self.lay.queue].copy_(g)
        self.p, self.h = 0, 0

    def _export(self) -> ShardedState:
        f = tuple(F[self.p] for F in self.F)
        if not self.lay.queue:
            return ShardedState(f)
        if self.slots == 1:
            return ShardedState(f, tuple(G[:1] for G in self.G))
        order = [(self.h + q) % self.slots for q in range(self.lay.queue)]
        return ShardedState(f, tuple(torch.cat([G[i:i + 1] for i in order]) for G in self.G))

    def _tots(self) -> torch.Tensor:
        """Per-step totals: each shard's sum (overlap's three rows as
        ``(interior + bottom) + top``), then the shards in global order,
        ``((T_0 + T_1) + T_2) + ...``, on the first local device.  With
        several processes one gather brings every shard's sums to every
        process, which adds them in the same order: every rank holds the
        one-process totals bitwise."""
        dev0, n = self.lay.mesh.devices[0], self.n
        rows = [((T[0, :n] + T[1, :n]) + T[2, :n] if self.kind == "overlap" else T[0, :n]).to(dev0)
                for T in self.T]
        if self.lay.mesh.world > 1 and n:
            rows = [v for block in gather(self.lay.mesh, torch.stack(rows)) for v in block]
        total = None
        for v in rows:
            total = v.clone() if total is None else total + v
        return total

    def __call__(self, state: ShardedState):
        self._load(state)
        if self.kind == "exchange":
            self._exchange()
        elif self.kind in ("chunked", "ca"):
            k, run = ((self.lay.staleness, self._chunk) if self.kind == "chunked"
                      else (self.lay.K, self._step_ca))
            if self.n % k:
                raise ValueError(f"{self.kind} runs take whole {k}-step sweeps, got {self.n} steps")
            for c in range(self.n // k):
                run(c * k)
        else:
            step = {"sync": self._step_sync, "overlap": self._step_overlap,
                    "async": self._step_async, "inner": self._inner}[self.kind]
            for t in range(self.n):
                step(t)
        self._main_waits_side()
        return self._export(), self._tots()


def build_sharded_program(
    params: LBMParams,
    obstacles: np.ndarray,
    mesh: mesh_lib.RowMesh,
    mode: str = "sync",
    staleness: int = 1,
    f0: np.ndarray | None = None,
    backend: str | None = None,
    storage: str = "f32",
) -> StepProgram:
    """Row-sharded step program over ``mesh`` in one discipline
    (``lbm_tpu``'s ``build_sharded_program``).

    ``mode``: ``sync``, ``overlap``, ``async`` (``staleness`` = the halo
    age k; k > 1 is async-k), ``chunked`` (``staleness`` = the chunk
    length k) or ``ca`` (depth K = ``ca_depth(staleness)``; its engine from
    :func:`ca_engine_choice`, the in-place engine's sub-slabs from
    :func:`ca_parts`; open seams are refused, as ``lbm_tpu`` does).
    ``backend``: ``cuda`` (K1-slab, K6 and the ca engines; their plain
    versions on the CPU) or ``torch`` (the plain slab step; f32 only, no
    ca); None picks ``cuda`` on a CUDA device, for int16 storage and for
    ca, else ``torch`` (``jnp`` / ``pallas`` are accepted as lbm_tpu's
    names).  ``storage``: ``f32`` or ``i16`` (int16
    state, ghosts exchanged as int16; the cuda backend).  ``f0``: the
    initial (9, ny, nx) distributions, default the rest state.

    With several processes (``mesh.world`` > 1) every process builds the
    program with the same arguments: its state holds its own shards,
    ``step`` and the runners exchange with the other processes, and
    ``f_of`` and the per-step sums are gathered, so every process calls
    them in the same order and gets the one-process result bitwise."""
    ny_orig, nx = obstacles.shape
    R = mesh.size
    dev0 = mesh.devices[0]
    plan = plan_sharded(params, obstacles, R, mode, staleness, backend, storage, dev0.type)
    backend, ny, nloc, open_pad = plan.backend, plan.ny, plan.nloc, plan.open_pad
    K, engine, parts, pad_rows = plan.K, plan.engine, plan.parts, ny - ny_orig
    if pad_rows:
        # Walled seam: blocked rows at rest.  Open seam: live clones of the
        # global first rows (modes.py:967-1005).
        obstacles = np.concatenate([obstacles, np.ones((pad_rows, nx), dtype=bool)], axis=0)
        if f0 is not None:
            f0 = np.asarray(f0, dtype=np.float32)
            tail = (f0[:, :pad_rows, :] if open_pad
                    else lattice.equilibrium_rest(params.density, pad_rows, nx))
            f0 = np.concatenate([f0, tail], axis=1)
    if plan.stale_fraction > 0.05:
        warnings.warn(
            f"{mode} mode with {R} shards over {ny} rows at halo age {staleness} has an "
            f"effective stale-row exposure of {plan.stale_fraction:.1%}; deviation from the "
            "synchronous solution may exceed 1%. Use fewer shards, a larger grid, a "
            "smaller staleness, or the sync/overlap variants.",
            stacklevel=2,
        )

    tot_cells = int(obstacles.size - np.count_nonzero(obstacles))
    mine = range(mesh.first, mesh.first + mesh.local)  # this process's shards

    def per_shard(slabs):
        return tuple(torch.from_numpy(np.ascontiguousarray(slabs[r])).to(d)
                     for r, d in zip(mine, mesh.devices))

    obst = per_shard(_extended_obstacle_slabs(obstacles, R))
    k6 = plan.k6
    ca_obst = per_shard(_extended_obstacle_slabs(obstacles, R, K)) if mode == "ca" else ()
    lay = _Layout(params, mesh, mode, staleness, backend, storage, ny, nloc, nx, open_pad, obst,
                  k6, K, engine, parts, ca_obst)

    if f0 is None:  # the rest state is uniform, pad rows included
        f_init = [lattice.equilibrium_rest_device(params.density, nloc, nx, d)
                  for d in mesh.devices]
    else:
        f_init = [torch.from_numpy(np.ascontiguousarray(f0[:, r * nloc:(r + 1) * nloc]))
                  .to(d) for r, d in zip(mine, mesh.devices)]
    if storage == "i16":
        f_init = [quant.quantize(x, params.density) for x in f_init]
    ghosts = None
    if lay.queue:
        ghosts = tuple(torch.stack([torch.stack([lo, hi])] * lay.queue)
                       for lo, hi in lay.edges(f_init))
    init_state = ShardedState(tuple(f_init), ghosts)

    def make_run_all(num_steps):
        return _Runner(lay, num_steps, mode)

    spc = plan.spc
    runners: dict[str, _Runner] = {}

    def call_once(kind, n, state):
        """A functional call of a cached runner: the result is copied out
        of its buffers."""
        if kind not in runners:
            runners[kind] = _Runner(lay, n, kind)
        new, tots = runners[kind](state)
        return new.clone(), tots

    def step(state):
        new, tots = call_once(mode, spc, state)
        return new, (tots if spc > 1 else tots[0])

    chunk_inner_step = chunk_exchange = None
    if mode == "chunked":

        def chunk_inner_step(state):
            new, tots = call_once("inner", 1, state)
            return new, tots[0]

        def chunk_exchange(state):
            return call_once("exchange", 0, state)[0]

    def f_of(state):
        f = torch.cat([x.to(dev0) for x in state.f], dim=1)
        if mesh.world > 1:  # every process's rows, gathered in row order on each
            if storage == "i16":
                f = quant.dequantize(f, params.density)
            return torch.cat(gather(mesh, f), dim=1)[:, :ny_orig]
        f = f[:, :ny_orig]
        return quant.dequantize(f, params.density) if storage == "i16" else f

    # The frame: the shards gathered in row order on the first device (on
    # every process), dequantized for int16, seam padding dropped
    # (modes.py:1550-1562).
    mag = u_mag_fn(torch.from_numpy(np.ascontiguousarray(obstacles[:ny_orig])).to(dev0))

    return StepProgram(
        init_state=init_state,
        step=step,
        make_run_all=make_run_all,
        f_of=f_of,
        tot_cells=tot_cells,
        variant=plan.label,
        steps_per_call=spc,
        chunk_inner_step=chunk_inner_step,
        chunk_exchange=chunk_exchange,
        engine=engine,
        u_mag=lambda state: mag(f_of(state)),
        global_shape=(ny, nx),
    )
