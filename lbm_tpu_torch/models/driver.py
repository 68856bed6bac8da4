"""Simulation driver: initialise, run the step loop, collate.

The counterpart of ``lbm_tpu/models/driver.py`` for a single-device run
with f32 or i16 storage: the init / compute / collate phases of the
reference's ``main()`` (SerialCode/d2q9-bgk.c:132-205), long runs cut into
4000-step segments (``_segment_lengths``; on the temporal path a segment is
whole K-step sweeps, the run's last one with a K1 tail), the first launch
of each kernel and the kernel build billed to init, av = tot_u / fluid
cells in float32, and the output state taken through the program's
``f_of`` (dequantized for i16, lbm_tpu/models/driver.py:759).

Launches are asynchronous, so the compute bracket ends with
``torch.cuda.synchronize()``; without it the run would report the rate at
which launches were queued.  Inside the loop nothing waits for the device
and nothing is allocated per step: each segment's runner holds its buffers.

Not yet ported: frames, debug, checkpoint/resume, plans and the sharded
variants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.core import oracle
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models.program import StepProgram, build_single_program
from lbm_tpu_torch.models.variants import resolve_variant
from lbm_tpu_torch.ops import quant
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
    """The variant to run; i16 storage needs the cuda variant (whose
    wrappers run their plain versions on the CPU), as lbm_tpu's needs
    pallas (lbm_tpu/models/driver.py:208-216, 786-788)."""
    quant.check_storage(storage)
    v = resolve_variant(variant)
    if storage == "i16":
        if v == "serial":
            raise ValueError("storage 'i16' is not supported by the serial oracle variant")
        if v == "torch":
            raise ValueError("storage 'i16' requires the cuda variant; drop --variant torch")
        return "cuda"
    if v == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return v


def _segment_lengths(num_steps: int, config: RunConfig, sweep_k: int = 1) -> list[int] | None:
    """Split num_steps into fixed-size segments, or None to run one call.
    On the temporal path a segment is whole sweeps (rounded down to a
    multiple of ``sweep_k``, at least one sweep), so that only the run's
    last segment has a K1 tail, as an unsegmented run does: int16 state is
    then quantized at the same steps either way."""
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
    variant = pick_variant(config.variant, device, config.storage)
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
    program: StepProgram = build_single_program(
        params, scene.obstacles, device, backend=variant, f0=f0, storage=config.storage,
        temporal_k=config.temporal_k,
    )
    seg_lengths = (_segment_lengths(num_steps, config, program.sweep_k)
                   or ([num_steps] if num_steps else []))
    runners = {n: program.make_run_all(n) for n in sorted(set(seg_lengths))}
    if device.type == "cuda":
        # A discarded run that launches each kernel once (a step, or a sweep
        # and a step): a kernel's first launch loads it, which belongs to
        # init with the build.
        program.make_run_all(program.sweep_k + (program.sweep_k > 1))(program.init_state)
        _sync(device)
    timer.stop("init")

    timer.start("compute")
    state, parts = program.init_state, []
    for n in seg_lengths:
        state, tot_us = runners[n](state)
        parts.append(tot_us)
    _sync(device)
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
    return RunResult(f, av_vels, reynolds, timer, program.variant, device_name(device))
