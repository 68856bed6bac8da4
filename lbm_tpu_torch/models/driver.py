"""Simulation driver: initialise, run the step loop, collate.

The counterpart of ``lbm_tpu/models/driver.py`` for single-device and
row-sharded runs with f32 or i16 storage: the init / compute / collate
phases of the reference's ``main()`` (SerialCode/d2q9-bgk.c:132-205), long
runs cut into 4000-step segments (``_segment_lengths``; on the temporal
path a segment is whole K-step sweeps, the run's last one with a K1 tail;
on the chunked path whole chunks), the first launch of each kernel and the
kernel build billed to init, av = tot_u / fluid cells in float32, and the
output state taken through the program's ``f_of`` (dequantized for i16,
lbm_tpu/models/driver.py:759).

The sharded variants (sync, overlap, async, async-k, chunked, ca) run on a
row mesh (parallel/mesh.py, parallel/modes.py): ``num_devices`` shards over
the run's devices, every card of a CUDA host, or ``host_devices`` copies of
the run's one device.  A chunked run whose step count is not a multiple of
k runs the remainder as exchange-then-inner per step, through the
program's chunk primitives; a ca run (whose state is the bare f) runs it
through a sync program on the same mesh, continuing from the bulk's final
state (lbm_tpu/models/driver.py:879-935).  Either variant then reads
``...+sync-tailN``.

Launches are asynchronous, so the compute bracket ends with
``torch.cuda.synchronize()`` on every device of the run; without it the
run would report the rate at which launches were queued.  Inside the loop
nothing waits for the device and nothing is allocated per step: each
segment's runner holds its buffers.

Not yet ported: frames, debug, checkpoint/resume and plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.core import oracle
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models.program import StepProgram, build_single_program
from lbm_tpu_torch.models.variants import SHARDED, resolve_variant
from lbm_tpu_torch.ops import quant
from lbm_tpu_torch.parallel import mesh as mesh_lib
from lbm_tpu_torch.parallel import modes
from lbm_tpu_torch.utils.invariants import calc_reynolds
from lbm_tpu_torch.utils.timing import PhaseTimer

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


@dataclasses.dataclass
class RunResult:
    f: np.ndarray  # (9, ny, nx) final distributions
    av_vels: np.ndarray  # (steps,) float32
    reynolds: float
    timer: PhaseTimer
    variant: str
    device: str

    @property
    def mlups(self) -> float:
        """Million lattice-cell updates per second of the compute phase."""
        cells = self.f.shape[1] * self.f.shape[2]
        secs = self.timer.elapsed.get("compute", 0.0)
        return cells * len(self.av_vels) / secs / 1e6 if secs > 0 else float("nan")


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
    (raises when more are asked for than exist)."""
    return mesh_lib.make_row_mesh(config.num_devices,
                                  mesh_lib.available_devices(device, config.host_devices))


def ca_staleness(scene: Scene, config: RunConfig, n_dev: int) -> int:
    """The ca depth knob of a run: ``--staleness``, else
    ``modes.ca_default_staleness`` (lbm_tpu/models/driver.py:227-231)."""
    if config.staleness is not None:
        return config.staleness
    return modes.ca_default_staleness(scene.params, scene.obstacles, n_dev, config.storage)


def choose_variant(scene: Scene, config: RunConfig, device: torch.device) -> str:
    """The variant a run takes: the one named, or for ``auto`` on more than
    one device ``lbm_tpu``'s multi-device rule (driver.py:141-175), else the
    single-device one; ``--backend`` names the single-device variant, as in
    lbm_tpu.

    The devices are ``num_devices`` of the run's devices: every card of a
    CUDA host, or ``host_devices`` copies of the run's one device.  On more
    than one: ``ca`` wherever it maps at the depth the run will use
    (``modes.ca_supported``; not on the torch backend), else the stale-row
    model's async where its deviation stays well inside the 1% contract,
    else the exact overlap."""
    v = resolve_variant(config.variant)
    if v == "auto":
        n_dev = (config.num_devices if config.num_devices is not None
                 else len(mesh_lib.available_devices(device, config.host_devices)))
        if n_dev > 1:
            backend = {"jnp": "torch", "pallas": "cuda"}.get(config.backend, config.backend)
            if backend != "torch" and modes.ca_supported(
                    scene.params, scene.obstacles, n_dev, ca_staleness(scene, config, n_dev),
                    config.storage):
                return "ca"
            return "async" if 2.0 * n_dev / scene.params.ny <= 0.03 else "overlap"
    if v not in SHARDED and v != "serial" and config.backend is not None:
        backend = {"jnp": "torch", "pallas": "cuda"}.get(config.backend, config.backend)
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
        mode = "async" if variant == "async-k" else variant
        mesh = mesh_devices(config, device)
        if variant == "ca":
            staleness = ca_staleness(scene, config, mesh.size)
        elif config.staleness is not None and variant in modes.STALENESS_DEFAULTS:
            staleness = config.staleness
        else:
            staleness = modes.STALENESS_DEFAULTS.get(variant, 1)
        f_host = None if f0 is None else np.asarray(torch.as_tensor(f0).cpu(), np.float32)
        return modes.build_sharded_program(
            params, obst, mesh, mode=mode, staleness=staleness,
            f0=f_host, backend=config.backend, storage=config.storage,
        )
    return build_single_program(params, obst, device, backend=variant, f0=f0,
                                storage=config.storage, temporal_k=config.temporal_k)


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


def _tail_runner(scene: Scene, config: RunConfig, device: torch.device,
                 program: StepProgram, num_steps: int):
    """The runner of a multi-step program's last ``num_steps`` (fewer than
    one sweep or chunk), ``state -> (state, tot_us (num_steps,))``: a
    chunked program's own primitives (:func:`_run_tail`), or, for ca, whose
    state is the bare f, a sync program on the same mesh, storage and
    backend, which continues the bulk's final state bitwise
    (lbm_tpu/models/driver.py:914-941)."""
    if program.chunk_inner_step is not None:
        return lambda state: _run_tail(program, state, num_steps)
    sync_cfg = dataclasses.replace(config, variant="sync", staleness=None, temporal_k=None)
    return build_program(scene, sync_cfg, device, variant="sync").make_run_all(num_steps)


def _run_tail(program: StepProgram, state, num_steps: int):
    """``num_steps`` steps of a chunked program as exchange-then-inner per
    step (fresh ghosts every step: the sync discipline); returns (state,
    tot_us (num_steps,))."""
    tots = []
    for _ in range(num_steps):
        state = program.chunk_exchange(state)
        state, tot_u = program.chunk_inner_step(state)
        tots.append(tot_u.reshape(1))
    return state, torch.cat(tots)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_simulation(
    scene: Scene,
    config: RunConfig | None = None,
    f0: torch.Tensor | np.ndarray | None = None,
) -> RunResult:
    """Run a simulation: init -> compute -> collate.

    ``f0`` (9, ny, nx) continues from a given state (e.g. one handed over
    from ``lbm_tpu`` by io/state.py) instead of the rest equilibrium."""
    config = config or RunConfig()
    device = resolve_device(config.device)
    variant = choose_variant(scene, config, device)
    params = scene.params
    num_steps = config.num_steps if config.num_steps is not None else params.max_iters
    timer = PhaseTimer()

    if variant == "serial":
        with timer.section("init"):
            f_init = None if f0 is None else torch.as_tensor(f0).cpu().numpy()
        with timer.section("compute"):
            f, av_vels = oracle.run(params, scene.obstacles, f=f_init, num_steps=num_steps)
        with timer.section("collate"):
            pass
        reynolds = calc_reynolds(params, av_vels[-1]) if num_steps else 0.0
        return RunResult(f, av_vels, reynolds, timer, variant, "cpu")

    timer.start("init")
    program = build_program(scene, config, device, f0, variant)
    devices = mesh_devices(config, device).distinct if variant in SHARDED else (device,)
    spc = program.steps_per_call
    tail = num_steps % spc
    bulk = num_steps - tail
    seg_lengths = (_segment_lengths(bulk, config, max(program.sweep_k, spc))
                   or ([bulk] if bulk else []))
    runners = {n: program.make_run_all(n) for n in sorted(set(seg_lengths))}
    tail_run = _tail_runner(scene, config, device, program, tail) if tail else None
    if device.type == "cuda":
        # A discarded run that launches each kernel once (a step, or a sweep
        # and a step, or a chunk or ca sweep, and the tail): a kernel's
        # first launch loads it, which belongs to init with the build.
        state, _ = program.make_run_all(max(spc, program.sweep_k + (program.sweep_k > 1)))(
            program.init_state)
        if tail:
            tail_run(state)
        for d in devices:
            _sync(d)
    timer.stop("init")

    timer.start("compute")
    state, parts = program.init_state, []
    for n in seg_lengths:
        state, tot_us = runners[n](state)
        parts.append(tot_us)
    if tail:
        state, tot_us = tail_run(state)
        parts.append(tot_us)
    for d in devices:
        _sync(d)
    timer.stop("compute")

    timer.start("collate")
    if parts:
        tot_us = torch.cat(parts).cpu().numpy().astype(np.float32, copy=False)
    else:
        tot_us = np.zeros(0, dtype=np.float32)
    f = program.f_of(state).cpu().numpy().astype(np.float32, copy=False)
    av_vels = tot_us / np.float32(program.tot_cells)
    timer.stop("collate")

    reynolds = calc_reynolds(params, av_vels[-1]) if num_steps else 0.0
    label = program.variant + (f"+sync-tail{tail}" if tail else "")
    return RunResult(f, av_vels, reynolds, timer, label, device_name(device))
