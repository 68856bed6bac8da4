"""Simulation driver: initialise, run the step loop, collate.

The counterpart of ``lbm_tpu/models/driver.py`` for a single-device f32
run: the init / compute / collate phases of the reference's ``main()``
(SerialCode/d2q9-bgk.c:132-205), long runs cut into 4000-step segments
(``_segment_lengths``), the first launch and the kernel build billed to
init, and av = tot_u / fluid cells in float32.

Launches are asynchronous, so the compute bracket ends with
``torch.cuda.synchronize()``; without it the run would report the rate at
which launches were queued.  Inside the loop nothing waits for the device
and nothing is allocated per step: each segment's runner holds its buffers.

Not yet ported: frames, debug, checkpoint/resume, i16 storage, plans,
temporal blocking and the sharded variants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.core import oracle
from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models.program import StepProgram, build_single_program
from lbm_tpu_torch.models.variants import resolve_variant
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


def pick_variant(variant: str, device: torch.device) -> str:
    v = resolve_variant(variant)
    if v == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return v


def _segment_lengths(num_steps: int, config: RunConfig) -> list[int] | None:
    """Split num_steps into fixed-size segments, or None to run one call."""
    seg = config.segment_steps
    if seg is None:
        seg = _SEGMENT_STEPS
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
    variant = pick_variant(config.variant, device)
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
        params, scene.obstacles, device, backend=variant, f0=f0
    )
    seg_lengths = _segment_lengths(num_steps, config) or ([num_steps] if num_steps else [])
    runners = {n: program.make_run_all(n) for n in sorted(set(seg_lengths))}
    if device.type == "cuda":
        # One discarded step: the first launch of each kernel loads its
        # module, which belongs to init with the build.
        program.make_run_all(1)(program.init_state)
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
    f = state.cpu().numpy().astype(np.float32, copy=False)
    av_vels = tot_us / np.float32(program.tot_cells)
    timer.stop("collate")

    reynolds = calc_reynolds(params, av_vels[-1]) if num_steps else 0.0
    return RunResult(f, av_vels, reynolds, timer, program.variant, device_name(device))
