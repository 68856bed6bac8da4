"""Simulation driver: initialise, run the step loop, collate.

The counterpart of ``lbm_tpu/models/driver.py`` for single-device and
row-sharded runs with f32 or i16 storage: the init / compute / collate
phases of the reference's ``main()`` (SerialCode/d2q9-bgk.c:132-205), long
runs cut into 4000-step segments (``_segment_lengths``; on the temporal
path a segment is whole K-step sweeps, the run's last one with a K1 tail,
counted in ``RunResult.sweep_k``, ``sweeps`` and ``tail_steps``;
on the chunked path whole chunks), the first launch of each kernel and the
kernel build billed to init, av = tot_u / fluid cells in float32, and the
output state taken through the program's ``f_of`` (dequantized for i16,
lbm_tpu/models/driver.py:759).  The outputs reach host memory through
utils/hostcopy.py: their host arrays are prepared before the compute
bracket's synchronize, under the card's queued steps, and filled in the
collate through a reused page-locked ring.

The sharded variants (sync, overlap, async, async-k, chunked, ca) run on a
row mesh (parallel/mesh.py, parallel/modes.py): ``num_devices`` shards over
the run's devices, every card of a CUDA host, or ``host_devices`` copies of
the run's one device.  A chunked run whose step count is not a multiple of
k runs the remainder as exchange-then-inner per step, through the
program's chunk primitives; a ca run (whose state is the bare f) runs it
through a sync program on the same mesh, continuing from the bulk's final
state (lbm_tpu/models/driver.py:879-935).  Either variant then reads
``...+sync-tailN``.

Every run is one loop over segments (:func:`_segments`), each advanced
through the program's own runners (:class:`_Advance`), with a hook after
each segment (:func:`_observers`; ``lbm_tpu``'s ``_make_scan`` :322-654
and ``_run_with_checkpoints`` :689-769):

- **plain**: whole sweeps or chunks in 4000-step segments, then the tail;
- **frames** (``frame_interval``): frame k is |u| (``program.u_mag``) of
  the state after k * interval + 1 steps, ``frame_steps = start + k *
  interval``.  The run advances between captures through the program's
  ``make_run_all`` (K2, K3, K10, K4, K1 on one device; the sharded
  programs' runners), a chunked program through whole chunks and its chunk
  primitives at mid-chunk phases, exchanging before every step from
  ``bulk_start`` on (the plain run's sync tail), and ca through whole ca
  sweeps, its odd steps through a sync program.  The frames buffer is
  allocated once on the device, before the compute bracket;
- **debug**: one step per call of the program's own ``make_run_all(1)``
  (a chunked program: its primitives), tot_u and the total density after
  every step, printed after the timed loop in ``lbm_tpu``'s format; an
  f32 ca run (int16 where its engine is K8-i16,
  ``modes.ca_decomposes_per_step``) is observed through its bitwise-equal
  sync schedule and reads ``ca-K+debug-as-sync``;
- **checkpoints**: segments of ``checkpoint_every`` steps, after each
  ``ckpt_%08d.npz`` (``f`` through ``f_of``, ``step``, ``av_vels``), inside
  the compute bracket; ``resume_from`` continues one (io/state.py),
  ``av_vels`` prefixed.

So plain, frames and debug runs are bitwise equal on fields at any step
count on every variant with a per-step decomposition; av_vels too wherever
the kernel's per-step |u| grouping does not depend on where a launch
starts (every single-device kernel but the sweeps' K1 tails).

With ``profile_dir`` the compute bracket, and only it, runs under
``torch.profiler`` (host and, on a card, CUPTI's kernel activity); its
Chrome trace lands in ``profile_dir/trace.json`` (rank r of a process
group: ``profile_dir/rank<r>/trace.json``, :func:`profile_dir_of`) and
``RunResult.profile`` sums its kernel events (:func:`_profile_summary`),
with one entry per rank under ``ranks`` (:func:`_gather_profiles`: one
small gather after the bracket has closed).  The profiler changes no
launch, so the outputs are those of the unprofiled run.  The trace holds
the bracket's ``lbm.compute`` range; under a profiler that spans the whole
call, each phase is a range (``lbm.init``, ``lbm.compute``,
``lbm.collate``, inside ``lbm.run_simulation``: utils/timing.py).

In a process group (parallel/mesh.py ``join``; ``python -m lbm_tpu_torch
run`` under a launcher) every process runs the same loop over its own
shards, ``host_devices`` (default 1) each, and calls every collective
(exchanges, the gathered sums, ``f_of``) in the same order; only rank 0
writes checkpoints and prints the debug report (cli.py writes the files),
and the single-device variants are refused.

Launches are asynchronous, so the compute bracket ends with
``torch.cuda.synchronize()`` on every device of the run; without it the
run would report the rate at which launches were queued.  Inside the loop
nothing waits for the device and nothing is allocated per step: each
segment's runner holds its buffers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import warnings

import numpy as np
import torch

from lbm_tpu_torch.core import oracle
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.io.state import load_reference_checkpoint
from lbm_tpu_torch.models.program import StepProgram, build_single_program
from lbm_tpu_torch.models.variants import SHARDED, resolve_variant
from lbm_tpu_torch.ops import quant
from lbm_tpu_torch.parallel import exchange
from lbm_tpu_torch.parallel import mesh as mesh_lib
from lbm_tpu_torch.parallel import modes
from lbm_tpu_torch.utils import hostcopy
from lbm_tpu_torch.utils.invariants import calc_reynolds
from lbm_tpu_torch.utils.timing import PhaseTimer, span

# Default segment length for long runs (lbm_tpu/models/driver.py:665): 4000
# divides every reference scene's maxIters.  A segment is one runner call;
# segments are pure execution boundaries, so a segmented run is bitwise
# equal to an unsegmented one.
_SEGMENT_STEPS = 4000


@dataclasses.dataclass
class RunConfig:
    variant: str = "auto"
    device: str = "cuda"  # "cuda" or "cpu"; never chosen silently
    num_steps: int | None = None  # override params.max_iters
    # Steps per runner call: None = auto (_SEGMENT_STEPS for longer runs),
    # 0 = one call for the whole run, N > 0 = segments of N steps.
    segment_steps: int | None = None
    storage: str = "f32"  # "f32" or "i16" (int16 state; needs the cuda variant)
    # K timesteps per device-memory sweep on the cuda path (ops/temporal_cuda.py,
    # ops/skew_cuda.py).  None = auto by grid, 1 = no sweeps, >= 2 = forced.
    temporal_k: int | None = None
    # Sharded variants: shards (None = every device of the run).
    num_devices: int | None = None
    # Halo age of async, chunk length of chunked, exchange depth of ca; None
    # = the variant's default (modes.STALENESS_DEFAULTS: async 1, async-k 2,
    # chunked 2; ca: modes.ca_default_staleness).
    staleness: int | None = None
    # "cuda" / "torch" (or lbm_tpu's "pallas" / "jnp"): the per-shard step of
    # the sharded variants, or the single-device variant; None = auto.
    backend: str | None = None
    # N: the run's one device counts as N devices (lbm_tpu's --host-devices).
    host_devices: int | None = None
    frame_interval: int | None = None  # capture |u| every k steps (None = off)
    debug: bool = False  # per-step tot_u and total density (SerialCode/d2q9-bgk.c:175-179)
    checkpoint_every: int | None = None  # save the state every N steps
    checkpoint_dir: str = "checkpoints"
    resume_from: str | None = None  # a checkpoint .npz to continue
    # A directory for a torch.profiler Chrome trace of the compute bracket
    # (lbm_tpu's profile_dir); None = no trace.
    profile_dir: str | None = None


@dataclasses.dataclass
class RunResult:
    f: np.ndarray  # (9, ny, nx) final distributions
    av_vels: np.ndarray  # (steps,) float32
    reynolds: float
    timer: PhaseTimer
    variant: str
    device: str
    frames: np.ndarray | None = None  # (n_frames, ny, nx) |u| snapshots
    frame_steps: np.ndarray | None = None
    # Steps this run's compute phase advanced (fewer than len(av_vels) when
    # it resumed a checkpoint: the prefix was computed earlier).
    steps_computed: int | None = None
    # profile_dir runs: what the trace holds (:func:`_profile_summary`).
    profile: dict | None = None
    # The temporal sweeps: steps a sweep (1 off the sweep path), the sweeps
    # this run's compute phase launched and the steps it ran on K1 after them.
    sweep_k: int = 1
    sweeps: int = 0
    tail_steps: int = 0

    @property
    def mlups(self) -> float:
        """Million lattice-cell updates per second of the compute phase."""
        cells = self.f.shape[1] * self.f.shape[2]
        steps = self.steps_computed if self.steps_computed is not None else len(self.av_vels)
        secs = self.timer.elapsed.get("compute", 0.0)
        return cells * steps / secs / 1e6 if secs > 0 else float("nan")


def resolve_device(name: str | torch.device) -> torch.device:
    """The run's device.  ``cuda`` with no CUDA device raises: the CPU is
    used only when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r}; use cuda or cpu")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def pick_variant(variant: str, device: torch.device, storage: str = "f32") -> str:
    """The single-device variant to run, or the sharded variant named; i16
    storage needs the cuda variant (whose wrappers run their plain versions
    on the CPU), as lbm_tpu's needs pallas (lbm_tpu/models/driver.py:208-216,
    786-788)."""
    quant.check_storage(storage)
    v = resolve_variant(variant)
    if v in SHARDED:
        return v
    if storage == "i16":
        if v == "serial":
            raise ValueError("storage 'i16' is not supported by the serial oracle variant")
        if v == "torch":
            raise ValueError("storage 'i16' requires the cuda variant; drop --variant torch")
        return "cuda"
    if v == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return v


def mesh_devices(config: RunConfig, device: torch.device) -> mesh_lib.RowMesh:
    """The row mesh of a sharded run: ``num_devices`` of the run's devices
    (raises when more are asked for than exist); in a process group,
    ``host_devices`` (default 1) shards on every process
    (``mesh_lib.run_mesh``)."""
    return mesh_lib.run_mesh(config.num_devices, device, config.host_devices)


def ca_staleness(scene: Scene, config: RunConfig, n_dev: int) -> int:
    """The ca depth knob of a run: ``--staleness``, else
    ``modes.ca_default_staleness`` (lbm_tpu/models/driver.py:227-231)."""
    if config.staleness is not None:
        return config.staleness
    return modes.ca_default_staleness(scene.params, scene.obstacles, n_dev, config.storage)


def _n_devices(config: RunConfig, device: torch.device) -> int:
    return (config.num_devices if config.num_devices is not None
            else mesh_devices(config, device).size)


def _backend(config: RunConfig) -> str | None:
    return {"jnp": "torch", "pallas": "cuda"}.get(config.backend, config.backend)


def choose_variant(scene: Scene, config: RunConfig, device: torch.device) -> str:
    """The variant a run takes: the one named, or for ``auto`` on more than
    one device ``lbm_tpu``'s multi-device rule (driver.py:141-175), else the
    single-device one; ``--backend`` names the single-device variant, as in
    lbm_tpu.

    The devices are ``num_devices`` of the run's devices: every card of a
    CUDA host, or ``host_devices`` copies of the run's one device.  On more
    than one: ``ca`` wherever it maps at the depth the run will use
    (``modes.ca_supported``; not on the torch backend) and, for a run with
    ``--debug`` or frames, can be observed per step
    (``modes.ca_decomposes_per_step``: int16 only on K8-i16), else the
    stale-row model's async where its deviation stays well inside the 1%
    contract, else the exact overlap.  In a process group only the sharded
    variants run: a single-device one raises."""
    v = resolve_variant(config.variant)
    world = mesh_lib.process_layout()[1]
    if world > 1 and v != "auto" and v not in SHARDED:
        raise ValueError(f"--variant {config.variant} runs on one device; {world} processes "
                         "run a sharded variant (sync, overlap, async, async-k, chunked, ca "
                         "or auto)")
    if v == "auto":
        n_dev = _n_devices(config, device)
        if n_dev > 1:
            observed = config.debug or config.frame_interval is not None
            engine = (modes.ca_engine_of(scene.params, scene.obstacles, n_dev,
                                         ca_staleness(scene, config, n_dev), config.storage)
                      if _backend(config) != "torch" else None)
            if engine is not None and (not observed
                                       or modes.ca_decomposes_per_step(engine, config.storage)):
                return "ca"
            return "async" if 2.0 * n_dev / scene.params.ny <= 0.03 else "overlap"
    if v not in SHARDED and v != "serial" and config.backend is not None:
        backend = _backend(config)
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {config.backend!r}; use 'torch' or 'cuda'")
        v = backend
    return pick_variant(v, device, config.storage)


def build_program(
    scene: Scene,
    config: RunConfig,
    device: torch.device,
    f0: torch.Tensor | np.ndarray | None = None,
    variant: str | None = None,
) -> StepProgram:
    """The step program of a run (lbm_tpu/models/driver.py:196-247)."""
    variant = variant or choose_variant(scene, config, device)
    params, obst = scene.params, scene.obstacles
    if variant in SHARDED:
        mesh = mesh_devices(config, device)
        mode, staleness = sharded_mode(scene, config, variant, mesh.size)
        f_host = None if f0 is None else np.asarray(torch.as_tensor(f0).cpu(), np.float32)
        return modes.build_sharded_program(
            params, obst, mesh, mode=mode, staleness=staleness,
            f0=f_host, backend=config.backend, storage=config.storage,
        )
    return build_single_program(params, obst, device, backend=variant, f0=f0,
                                storage=config.storage, temporal_k=config.temporal_k)


def sharded_mode(scene: Scene, config: RunConfig, variant: str, n_dev: int) -> tuple[str, int]:
    """(mode, staleness) of a sharded variant's program over ``n_dev``
    shards (lbm_tpu/models/driver.py:218-247): ``async-k`` is the async
    mode; ca's depth knob from :func:`ca_staleness`."""
    mode = "async" if variant == "async-k" else variant
    if variant == "ca":
        return mode, ca_staleness(scene, config, n_dev)
    if config.staleness is not None and variant in modes.STALENESS_DEFAULTS:
        return mode, config.staleness
    return mode, modes.STALENESS_DEFAULTS.get(variant, 1)


def _segment_lengths(num_steps: int, config: RunConfig, sweep_k: int = 1) -> list[int] | None:
    """Split num_steps into fixed-size segments, or None to run one call.
    On the temporal path a segment is whole sweeps (rounded down to a
    multiple of ``sweep_k``, at least one sweep), so that only the run's
    last segment has a K1 tail, as an unsegmented run does: int16 state is
    then quantized at the same steps either way.  The chunked path passes
    its chunk length, so that every segment is whole chunks."""
    seg = config.segment_steps
    if seg is None:
        seg = _SEGMENT_STEPS
    if seg > 0:
        seg = max(sweep_k, seg - seg % sweep_k)
    if seg <= 0 or num_steps <= seg:
        return None
    lengths = [seg] * (num_steps // seg)
    if num_steps % seg:
        lengths.append(num_steps % seg)
    return lengths


def _sync_program(scene: Scene, config: RunConfig, device: torch.device) -> StepProgram:
    """A sync program on the run's mesh, storage and backend: it continues a
    ca state (the bare f) bitwise (lbm_tpu/models/driver.py:914-941)."""
    sync_cfg = dataclasses.replace(config, variant="sync", staleness=None, temporal_k=None)
    return build_program(scene, sync_cfg, device, variant="sync")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _segments(config: RunConfig, program: StepProgram, num_steps: int) -> list[tuple[int, int]]:
    """:func:`plan_segments` of a built program."""
    return plan_segments(config, num_steps, program.steps_per_call, program.sweep_k,
                         program.chunk_inner_step is not None, program.variant)


def plan_segments(config: RunConfig, num_steps: int, spc: int = 1, sweep_k: int = 1,
                  chunked: bool = False, variant: str = "") -> list[tuple[int, int]]:
    """The segments ``(start, n)`` that a run's ``num_steps`` steps advance
    in, one advance each, for a program of ``spc`` steps per call
    (``chunked``: with chunk primitives) and sweeps of ``sweep_k`` steps:
    with ``--debug`` one per step; with frames one step, then
    ``frame_interval`` steps per further frame (frame k is the state after
    k * interval + 1 steps), then the rest (``lbm_tpu``'s ``_make_scan``,
    driver.py:459-652); with checkpoints ``checkpoint_every`` steps
    (:722-725); else whole sweeps or chunks (:func:`_segment_lengths`),
    then the tail of a multi-step program, fewer steps than one chunk or ca
    sweep.  Raises with ``lbm_tpu``'s refusals (:345-346, :410-416,
    :713-720)."""
    chunked = spc > 1 and chunked
    interval = config.frame_interval
    if config.debug:
        if chunked and interval is not None:
            raise ValueError("frames and --debug cannot be combined")
        lengths = [1] * num_steps
    elif interval is not None:
        if chunked and interval % spc:
            raise ValueError(
                f"frame capture with {variant} requires --frame-interval to be a "
                f"multiple of the {spc}-step chunk (capture segments must all start at the "
                "same in-chunk phase)")
        lengths = [1] + [interval] * (math.ceil(num_steps / interval) - 1) if num_steps else []
    elif config.checkpoint_every is not None:
        seg = config.checkpoint_every
        if spc > 1 and seg % spc:
            raise ValueError("checkpoint_every must be a multiple of the chunk size")
        if spc > 1 and num_steps % spc:
            raise ValueError(
                f"checkpointed {variant} runs require the step count to be a multiple "
                f"of the {spc}-step chunk (drop --checkpoint-every to run the remainder as a "
                "sync tail)")
        lengths = [seg] * (num_steps // seg)
    else:
        bulk = num_steps - num_steps % spc
        lengths = (_segment_lengths(bulk, config, max(sweep_k, spc))
                   or ([bulk] if bulk else []))
    if sum(lengths) < num_steps:
        lengths.append(num_steps - sum(lengths))
    starts = [0, *itertools.accumulate(lengths)][:len(lengths)]
    return list(zip(starts, lengths))


class _Advance:
    """The advances of a run's segments, ``state -> (state, (n,) tot_us)``
    for its steps [start, start + n), through the program's own runners,
    built in init once per distinct length (their buffers allocated there).
    A multi-step program runs whole chunks or ca sweeps where a segment
    holds them, and the rest:

    - chunked: through its primitives, inner steps with an exchange at
      every chunk boundary and, from ``bulk_start`` (the end of the run's
      last whole chunk) on, one before every inner step, the plain run's
      sync tail (``lbm_tpu``'s driver.py:547-579);
    - ca, whose state is the bare f: a sync program on the same mesh,
      storage and backend, which continues it bitwise (:580-602, :914-941).
    """

    def __init__(self, scene: Scene, config: RunConfig, device: torch.device,
                 program: StepProgram, num_steps: int):
        self.program, self.spc = program, program.steps_per_call
        self.chunked = self.spc > 1 and program.chunk_inner_step is not None
        self.bulk_start = num_steps - num_steps % self.spc
        self._new_sync = lambda: _sync_program(scene, config, device)
        self._sync_prog = None
        self._runners: dict = {}
        self.primitives = False

    def _runner(self, program: StepProgram, n: int):
        key = (id(program), n)
        if key not in self._runners:
            self._runners[key] = program.make_run_all(n)
        return self._runners[key]

    def __call__(self, start: int, n: int):
        p, spc = self.program, self.spc
        if spc == 1:
            return self._runner(p, n)
        pieces, pos, end = [], start, start + n
        if self.chunked:
            while pos < end:
                whole_end = min(end, self.bulk_start)
                whole = (whole_end - pos) // spc * spc if pos % spc == 0 else 0
                if whole > 0:
                    pieces.append(self._runner(p, whole))
                    pos += whole
                    continue
                first = pos
                pos += 1
                while pos < end and (pos % spc or pos + spc > whole_end):
                    pos += 1
                pieces.append(functools.partial(self._primitive_steps, first, pos))
                self.primitives = True
        else:
            calls, odd = divmod(n, spc)  # ca: whole sweeps, then sync steps
            if calls:
                pieces.append(self._runner(p, calls * spc))
            if odd:
                self._sync_prog = self._sync_prog or self._new_sync()
                pieces.append(self._runner(self._sync_prog, odd))
        if len(pieces) == 1:
            return pieces[0]

        def advance(state):
            parts = []
            for run in pieces:
                state, t = run(state)
                parts.append(t)
            return state, torch.cat(parts)

        return advance

    def _primitive_steps(self, first: int, stop: int, state):
        p, spc = self.program, self.spc
        tots = []
        for pos in range(first, stop):
            if pos >= self.bulk_start:
                state = p.chunk_exchange(state)
            state, tot_u = p.chunk_inner_step(state)
            tots.append(tot_u.reshape(1))
            if pos + 1 <= self.bulk_start and (pos + 1) % spc == 0:
                state = p.chunk_exchange(state)  # the chunk's own exchange
        return state, torch.cat(tots)

    def warm(self) -> None:
        """A discarded run that launches each kernel once (a step, or a
        sweep and a step, or a chunk or ca sweep; the primitives and the
        sync program where segments take them): a kernel's first launch
        loads it, which belongs to init with the build.  Every runner of a
        program shares its kernels."""
        p = self.program
        state, _ = p.make_run_all(max(self.spc, p.sweep_k + (p.sweep_k > 1)))(p.init_state)
        if self.primitives:
            p.chunk_exchange(p.chunk_inner_step(state)[0])
        if self._sync_prog is not None:
            self._sync_prog.make_run_all(1)(state)


def _observers(config: RunConfig, program: StepProgram, num_steps: int, dev: torch.device,
               tots: torch.Tensor, start_step: int, av_prefix: np.ndarray, writer: bool = True):
    """The hook a run calls after each segment, ``(end, state)`` with
    ``end`` the run's steps so far, or None; and the buffers of frames and
    of per-step densities it fills (or None), allocated here on the device,
    before the compute bracket.

    - frames: |u| (``program.u_mag``) of the state after k * interval + 1
      steps into frame k;
    - debug: the total density after every step (its tot_u is the
      segment's own);
    - checkpoints: the distributions (through ``f_of``), the step count and
      the av_vels so far into ``checkpoint_dir/ckpt_%08d.npz``, inside the
      compute bracket: it is a cost of checkpointing (driver.py:739-754).

    In a process group every process runs the hook (``f_of`` and
    ``u_mag`` gather the shards); only the ``writer`` writes checkpoints."""
    interval, every = config.frame_interval, config.checkpoint_every
    frames = dens = None
    if interval is not None:
        frames = torch.zeros((math.ceil(num_steps / interval), *program.global_shape),
                             dtype=torch.float32, device=dev)
    if config.debug:
        dens = torch.zeros(num_steps, dtype=torch.float32, device=dev)
    if every is not None:
        if writer:
            os.makedirs(config.checkpoint_dir, exist_ok=True)
    elif frames is None and dens is None:
        return None, None, None

    def hook(end: int, state) -> None:
        if dens is not None:
            dens[end - 1] = torch.sum(program.f_of(state), dtype=torch.float32)
        if frames is not None and (end - 1) % interval == 0:
            frame = program.u_mag(state)
            frames[(end - 1) // interval, :frame.shape[0], :frame.shape[1]] = frame
        if every is not None:
            step = start_step + end
            f = program.f_of(state).cpu().numpy().astype(np.float32, copy=False)
            if writer:
                av = (tots[:end].cpu().numpy().astype(np.float32, copy=False)
                      / np.float32(program.tot_cells))
                np.savez_compressed(
                    os.path.join(config.checkpoint_dir, f"ckpt_{step:08d}.npz"),
                    f=f, step=step, av_vels=np.concatenate([av_prefix, av]))

    return hook, frames, dens


def _load_resume(path: str, params, num_steps: int):
    """(f, step, av_vels) of a checkpoint to continue (lbm_tpu/models/driver.py:799-817)."""
    ck = load_reference_checkpoint(path)
    if ck.f.shape != (9, params.ny, params.nx):
        raise ValueError(f"checkpoint grid {ck.f.shape} does not match scene "
                         f"(9, {params.ny}, {params.nx})")
    if ck.step >= num_steps:
        raise ValueError(f"checkpoint is at step {ck.step}, beyond num_steps={num_steps}")
    return ck.f, ck.step, ck.av_vels


def _check_observable(scene, config, device, variant) -> str | None:
    """Refusals of observed runs that depend on the variant, before any
    program is built; returns the ca label (``ca-K`` or ``ca-K-i16``) when
    the run is to be observed through ca's sync schedule, else None."""
    if variant != "ca" or not (config.debug or config.frame_interval is not None):
        return None
    n_dev = _n_devices(config, device)
    staleness = ca_staleness(scene, config, n_dev)
    engine = modes.ca_engine_of(scene.params, scene.obstacles, n_dev, staleness,
                                config.storage, _backend(config))
    if engine is not None and not modes.ca_decomposes_per_step(engine, config.storage):
        if config.frame_interval is not None:
            raise ValueError(
                "--frame-interval with i16 ca is not supported: capture segments advance "
                "through per-step sync steps whose per-step quantization grouping differs "
                "from ca's once-per-sweep one, so the captured run would trace a different "
                "trajectory than the plain run; use f32 storage (or the chunked variant, "
                "whose primitives decompose exactly)")
        raise ValueError(
            f"debug tracing is not supported with ca-{modes.ca_depth(staleness)}-i16 "
            f"({modes.ca_depth(staleness)} steps per call and no per-step decomposition; "
            "i16 ca quantizes once per sweep, so the sync decomposition would trace a "
            "different trajectory); use the sync/overlap/async variants instead")
    if not config.debug:
        return None
    return f"ca-{modes.ca_depth(staleness)}" + ("-i16" if config.storage == "i16" else "")


def _profiler(device: torch.device):
    """A torch.profiler of the compute bracket: host activity, and the
    card's (CUPTI) on a CUDA run.  No shapes, no stacks: the trace of a
    long sharded run grows with its Python calls."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _busy_seconds(intervals: list[tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


def profile_dir_of(profile_dir: str) -> str:
    """The directory this process's trace goes into: ``profile_dir`` in one
    process, ``profile_dir/rank<r>`` for rank r of a process group, so that
    no two ranks write one file."""
    rank, world = mesh_lib.process_layout()
    return profile_dir if world == 1 else os.path.join(profile_dir, f"rank{rank}")


def _is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def _profile_summary(prof, out_dir: str, device: torch.device, compute_s: float) -> dict:
    """Write the bracket's Chrome trace to ``out_dir/trace.json`` and read
    its kernel events back: their count, launches and microseconds per
    kernel name, and the busy share (the union of their intervals over the
    compute bracket's seconds, which the profiler itself lengthens).  NCCL's
    kernels spin while they wait for a peer, so the union of the others
    (``lbm_busy_s``) and of NCCL's (``nccl_busy_s``) stand beside it.  On a
    CUDA run a trace without a kernel event raises: the card's activity was
    not recorded."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        events = json.load(fp).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if device.type == "cuda" and not kernels:
        raise ValueError(f"--profile: the trace {path} holds no CUDA kernel event; the "
                         "profiler could not record the card (CUPTI missing?)")

    def busy(keep):
        return _busy_seconds([(e["ts"], e["ts"] + e["dur"]) for e in kernels if keep(e)])

    total = busy(lambda e: True)
    by_name: dict = {}
    for e in kernels:
        launches, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (launches + 1, us + e["dur"])
    return {"trace": path, "kernel_events": len(kernels),
            "kernels": {k: {"launches": n, "us": us} for k, (n, us) in by_name.items()},
            "busy_s": total, "lbm_busy_s": busy(lambda e: not _is_nccl(e["name"])),
            "nccl_busy_s": busy(lambda e: _is_nccl(e["name"])), "compute_s": compute_s,
            "busy_share": total / compute_s if kernels and compute_s > 0 else None}


# What each rank's summary carries to the others (float64, one row a rank).
_PROFILE_ROW = ("kernel_events", "busy_s", "lbm_busy_s", "nccl_busy_s", "compute_s")


def _gather_profiles(summary: dict | None, error: Exception | None, dev: torch.device,
                     profile_dir: str) -> list[dict]:
    """Every rank's summary, in rank order: one gather of a float64 row of
    :data:`_PROFILE_ROW` and an ok flag, made after the traced bracket has
    closed.  A rank whose summary failed (``error``) still takes part, so
    that every rank raises together instead of waiting for it until the
    group's timeout: that rank re-raises its error, the others name it."""
    rank, world = mesh_lib.process_layout()
    if world == 1:
        if error is not None:
            raise error
        return [{"rank": 0, **summary}]
    row = [float(summary[k]) for k in _PROFILE_ROW] + [1.0] if error is None else [0.0] * 6
    rows = exchange.gather(mesh_lib.RowMesh((dev,), rank, world),
                           torch.tensor(row, dtype=torch.float64, device=dev))
    rows = [r.cpu().tolist() for r in rows]
    if error is not None:
        raise error
    failed = [r for r, x in enumerate(rows) if not x[-1]]
    if failed:
        raise ValueError(f"--profile failed on rank(s) {failed} (each printed its error)")
    out = []
    for r, x in enumerate(rows):
        got = dict(zip(_PROFILE_ROW, x[:-1]), kernel_events=int(x[0]))
        got["busy_share"] = (got["busy_s"] / got["compute_s"]
                             if got["kernel_events"] and got["compute_s"] > 0 else None)
        out.append({"rank": r, "trace": os.path.join(profile_dir, f"rank{r}", "trace.json"),
                    **got})
    return out


def check_config(config: RunConfig, variant: str) -> None:
    """The run's refusals that depend only on its options and its variant
    (lbm_tpu/models/driver.py:786-797, 963-972)."""
    observed = config.frame_interval is not None or config.debug
    if config.frame_interval is not None and config.frame_interval < 1:
        raise ValueError(f"--frame-interval must be at least 1, got {config.frame_interval}")
    if config.checkpoint_every is not None:
        if config.checkpoint_every < 1:
            raise ValueError(f"--checkpoint-every must be at least 1, got "
                             f"{config.checkpoint_every}")
        if observed:
            raise ValueError("frames/debug are not supported with checkpointing")
    if variant == "serial":
        if config.resume_from or config.checkpoint_every:
            raise ValueError("checkpoint/resume is not supported with the serial oracle "
                             "variant; use the torch or cuda variant")
        if observed:
            raise ValueError("frames and --debug are not supported with the serial oracle "
                             "variant; use the torch or cuda variant")


@span("run_simulation")
def run_simulation(
    scene: Scene,
    config: RunConfig | None = None,
    f0: torch.Tensor | np.ndarray | None = None,
) -> RunResult:
    """Run a simulation: init -> compute -> collate.

    ``f0`` (9, ny, nx) continues from a given state (e.g. one handed over
    from ``lbm_tpu`` by io/state.py) instead of the rest equilibrium;
    ``config.resume_from`` continues a checkpoint of either package."""
    config = config or RunConfig()
    device = resolve_device(config.device)
    variant = choose_variant(scene, config, device)
    params = scene.params
    num_steps = config.num_steps if config.num_steps is not None else params.max_iters
    timer = PhaseTimer()
    observed = config.frame_interval is not None or config.debug
    check_config(config, variant)

    if variant == "serial":
        with timer.section("init"):
            f_init = None if f0 is None else torch.as_tensor(f0).cpu().numpy()
        with timer.section("compute"):
            f, av_vels = oracle.run(params, scene.obstacles, f=f_init, num_steps=num_steps)
        with timer.section("collate"):
            pass
        reynolds = calc_reynolds(params, av_vels[-1]) if num_steps else 0.0
        return RunResult(f, av_vels, reynolds, timer, variant, "cpu", steps_computed=num_steps)

    start_step, av_prefix = 0, np.zeros(0, dtype=np.float32)
    if config.resume_from:
        if f0 is not None:
            raise ValueError("give either an initial state or a checkpoint to resume, not both")
        f0, start_step, av_prefix = _load_resume(config.resume_from, params, num_steps)
    remaining = num_steps - start_step

    timer.start("init")
    ca_label = _check_observable(scene, config, device, variant)
    if ca_label is not None:
        warnings.warn(f"--debug decomposes {ca_label} into its bitwise-identical sync schedule "
                      "(one exchange per step) for per-step observables", stacklevel=2)
        program = build_program(scene, dataclasses.replace(
            config, variant="sync", staleness=None, temporal_k=None), device, f0, "sync")
        program.variant = f"{ca_label}+debug-as-sync"
    else:
        program = build_program(scene, config, device, f0, variant)
    devices = mesh_devices(config, device).distinct if variant in SHARDED else (device,)
    segments = _segments(config, program, remaining)
    advance = _Advance(scene, config, device, program, remaining)
    advances = [advance(start, n) for start, n in segments]
    state = program.init_state  # sums and frames live with the first shard
    dev = state.f[0].device if isinstance(state, modes.ShardedState) else device
    tots = torch.zeros(remaining, dtype=torch.float32, device=dev)
    writer = mesh_lib.process_layout()[0] == 0  # the rank that writes and reports
    hook, frames, densities = _observers(config, program, remaining, dev, tots, start_step,
                                         av_prefix, writer)
    if device.type == "cuda":
        advance.warm()
        for d in devices:
            _sync(d)
    timer.stop("init")

    profiler = _profiler(device) if config.profile_dir else contextlib.nullcontext()
    with profiler:
        timer.start("compute")
        for (start, n), run in zip(segments, advances):
            state, tot_us = run(state)
            tots[start:start + n] = tot_us
            if hook is not None:
                hook(start + n, state)
        # The outputs' host arrays, faulted in while the card runs the queued steps.
        host_f = hostcopy.prepare((9, params.ny, params.nx), torch.float32, dev)
        host_tots = hostcopy.prepare(tots.shape, tots.dtype, dev)
        for d in devices:
            _sync(d)
        timer.stop("compute")
    profile = None
    if config.profile_dir:
        summary, error = None, None
        try:
            summary = _profile_summary(profiler, profile_dir_of(config.profile_dir), device,
                                       timer.elapsed["compute"])
        except Exception as e:  # raised on every rank by _gather_profiles
            error = e
        ranks = _gather_profiles(summary, error, dev, config.profile_dir)
        profile = {**summary, "ranks": ranks}

    timer.start("collate")
    f = hostcopy.fetch(program.f_of(state), host_f).astype(np.float32, copy=False)
    av_vels = hostcopy.fetch(tots, host_tots) / np.float32(program.tot_cells)
    if start_step:
        av_vels = np.concatenate([av_prefix, av_vels])
    if frames is not None:
        frames = frames.cpu().numpy()[:, :params.ny, :params.nx]
    if densities is not None:
        densities = densities.cpu().numpy()
    timer.stop("collate")

    frame_steps = (start_step + np.arange(frames.shape[0]) * config.frame_interval
                   if frames is not None else None)
    if densities is not None and writer:
        # The reference's DEBUG output, deferred out of the timed loop
        # (SerialCode/d2q9-bgk.c:175-179, lbm_tpu/models/driver.py:1046-1052).
        for tt in range(start_step, num_steps):
            print(f"==timestep: {tt}==")
            print("av velocity: %.12E" % av_vels[tt])
            print("tot density: %.12E" % densities[tt - start_step])

    reynolds = calc_reynolds(params, av_vels[-1]) if len(av_vels) else 0.0
    # A plain run's last segment is its tail (checkpointed runs have none).
    tail = 0 if observed else remaining % program.steps_per_call
    label = program.variant + (f"+sync-tail{tail}" if tail else "")
    K = program.sweep_k  # each segment's runner: n // K sweeps, then n % K K1 steps
    sweeps = sum(n // K for _, n in segments) if K > 1 else 0
    tail_steps = sum(n % K for _, n in segments) if K > 1 else 0
    return RunResult(f, av_vels, reynolds, timer, label, device_name(device), frames=frames,
                     frame_steps=frame_steps, steps_computed=remaining, profile=profile,
                     sweep_k=K, sweeps=sweeps, tail_steps=tail_steps)
