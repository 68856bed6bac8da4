"""Execution plan: what ``run`` would execute, without running it.

``python -m lbm_tpu_torch run ... --plan`` prints this and exits; the
counterpart of ``lbm_tpu/models/plan.py`` (``describe_plan`` :120).  Every
line comes from the selection functions the driver itself calls, in its
order (models/driver.py ``run_simulation``): ``driver.choose_variant``,
``driver.check_config``, ``driver._check_observable``, the single-device
policy ``program.cuda_choice`` (with ``resident_kind_choice``,
``temporal_impl_choice`` and ``temporal_cuda.pick_k`` inside it), the
sharded build's ``modes.plan_sharded`` (``ca_engine_of``, ``ca_parts``,
``ca_default_staleness``) and ``driver.plan_segments``
(``_segment_lengths``).  The forcing variables (``LBM_RESIDENT_KIND``,
``LBM_TEMPORAL_IMPL``, ``LBM_CA_ENGINE``, ``LBM_CA_PARTS``) are read now, as
the run reads them.  So the plan cannot drift from the run: where one of
those functions raises, the run raises the same error and the plan prints
``will FAIL: <reason>`` in its place.

Lines: the grid, steps and storage; the device; ``variant`` (the driver's
choice, ``(auto-selected)`` for ``--variant auto``; lbm_tpu's name there is
``jnp`` for ``torch`` and ``pallas`` for ``cuda``); ``program`` (the
``Variant`` line the run prints, ``RunResult.variant``); ``kernel`` by its
name in PERF.md's kernel table (K1-K10; ``-i16`` for int16 state); the
sweep depth; for sharded runs the shards (under a launcher: the processes
x local shards and the group's backend), the staleness or depth, and ca's
engine and sub-slabs; the segments; the frames, debug, checkpoint and
profile schedule.  No fold, VMEM limit or block table: those do not port.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings

from lbm_tpu_torch.io.scene import Scene
from lbm_tpu_torch.models import driver, program
from lbm_tpu_torch.models.variants import SHARDED, resolve_variant
from lbm_tpu_torch.ops import blocked_cuda, inplace_cuda, resident_cuda, temporal_cuda
from lbm_tpu_torch.parallel import modes

# The single-device variants' kernels (without ``-i16``): (table name, what,
# steps a launch; None: K steps a launch).
_SINGLE = {
    "cuda-resident": ("K2", "persistent multi-step kernel, two copies in L2",
                      resident_cuda.DEFAULT_CHUNK),
    "cuda-inplace": ("K3", "in-place persistent kernel, one copy in L2",
                     inplace_cuda.DEFAULT_CHUNK),
    "cuda-blocked": ("K10", "two-copy row-block kernel", blocked_cuda.DEFAULT_CHUNK),
    "cuda-trapezoid": ("K4", "trapezoid sweep", None),
    "cuda-skew": ("K5", "skewed sweep", None),
    "cuda-hbm": ("K9", "HBM-parts sweep", None),
    "cuda-step": ("K1", "one-step kernel", 1),
}
_ENGINES = {"slab": ("K4-slab", "slab sweep"), "resident": ("K7", "resident sweep"),
            "inplace": ("K8", "in-place sweep")}
_DISCIPLINES = {
    "sync": "exchange, then every shard's step (bitwise equal to one device)",
    "overlap": "interior rows while the halos are copied on a side stream "
               "(bitwise equal to sync)",
    "async": "ghosts {k} step(s) old (bounded staleness)",
    "chunked": "{k} local steps per exchange (ghost age 1..{k})",
    "ca": "{k}-deep exchange every {k} steps, one K-step sweep per shard (bitwise "
          "equal to sync)",
}


def _runs(lengths) -> str:
    """``1 x 1 + 199 x 100``: a list of lengths as runs of equal values."""
    return " + ".join(f"{len(list(g))} x {n}" for n, g in itertools.groupby(lengths))


def _single(out, scene: Scene, config, device, variant, announce) -> list:
    """The single-device program's lines; returns its segments."""
    params, storage = scene.params, config.storage
    if variant == "torch":
        segments = announce("torch", 1, 1, False)
        out("kernel: none (the plain PyTorch twin step)")
        return segments
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        label, K = program.cuda_choice(params, storage, config.temporal_k)
    for w in caught:
        out(f"note: {w.message}")
    segments = announce(label, 1, K, False)
    name, what, per_launch = _SINGLE[label.removesuffix("-i16")]
    sfx = "-i16" if storage == "i16" else ""
    per = ("one step a launch" if per_launch == 1 else f"up to {per_launch} steps a launch"
           if per_launch else f"K={K} steps a launch")
    line = f"kernel: {name}{sfx} ({what}; {per})"
    if K > 1:
        rest = sum(n % K for _, n in segments)
        if rest:
            line += f"; K1{sfx} for the {rest} step(s) outside whole sweeps"
    out(line + _plain_note(device))
    if K > 1:
        how = (f"--temporal-k {config.temporal_k}" if config.temporal_k is not None
               else f"auto: temporal_cuda.pick_k gives {temporal_cuda.pick_k(params, storage)}")
        out(f"sweep depth: K={K} ({how})")
    else:
        out("sweep depth: none" + (" (--temporal-k 1)" if config.temporal_k == 1 else ""))
    return segments


def _sharded(out, scene: Scene, config, device, variant, announce) -> list:
    """The sharded program's lines; returns its segments."""
    mesh = driver.mesh_devices(config, device)
    mode, staleness = driver.sharded_mode(scene, config, variant, mesh.size)
    sp = modes.plan_sharded(scene.params, scene.obstacles, mesh.size, mode, staleness,
                            config.backend, config.storage, mesh.devices[0].type)
    segments = announce(sp.label, sp.spc, 1, mode == "chunked")
    where = (f"{len(mesh.distinct)} device(s)" if len(mesh.distinct) > 1
             else f"one device, {mesh.devices[0]}")
    out(f"shards: {mesh.size} x {sp.nloc} rows ({where})"
        + (f", {sp.ny - scene.params.ny} padding row(s)" if sp.ny != scene.params.ny else ""))
    if mesh.world > 1:
        import torch.distributed as dist

        out(f"processes: {mesh.world} x {mesh.local} local shard(s), this rank {mesh.rank}; "
            f"backend {dist.get_backend()} (ghost rows between processes as messages)")
    depth = sp.K if mode == "ca" else staleness
    out(f"discipline: {mode}: " + _DISCIPLINES[mode].format(k=depth))
    if mode in ("async", "chunked"):
        out(f"staleness: {staleness}; stale-row exposure {sp.stale_fraction:.1%}"
            + (" (over 5%: the run warns)" if sp.stale_fraction > 0.05 else ""))
    out(f"per-shard backend: {sp.backend}")
    sfx = "-i16" if config.storage == "i16" else ""
    outside = any(start % sp.spc or n % sp.spc for start, n in segments)
    if sp.backend == "torch":
        out("kernel: none (the plain slab step on every shard)")
    elif mode == "ca":
        name, what = _ENGINES[sp.engine]
        split = f", {sp.parts} sub-slabs a shard" if sp.parts > 1 else ""
        out(f"ca engine: {sp.engine}, K={sp.K}, {sp.parts} part(s) (LBM_CA_ENGINE, LBM_CA_PARTS "
            "or the policy)")
        out(f"kernel: {name}{sfx} (ca {what}; K={sp.K} steps a launch per shard{split})"
            + (f"; K1-slab{sfx} for the sync steps outside whole sweeps" if outside else "")
            + _plain_note(device))
    elif mode == "chunked" and sp.k6:
        out(f"kernel: K6 (ghosted chunk kernel; {staleness} steps a launch per shard)"
            + ("; K1-slab for the steps outside whole chunks" if outside else "")
            + _plain_note(device))
    else:
        out(f"kernel: K1-slab{sfx} (one-step slab kernel; one launch per shard step"
            + (", three sub-slabs a shard" if mode == "overlap" else "") + ")"
            + _plain_note(device))
    return segments


def _plain_note(device) -> str:
    return "; its plain version on the CPU" if device.type == "cpu" else ""


def describe_plan(scene: Scene, config: driver.RunConfig) -> str:
    """The plan of ``run_simulation(scene, config)``, one line per fact;
    ``will FAIL: <reason>`` where the run would raise, with the run's
    reason.  Raises only what the run raises before it chooses anything:
    an unusable ``config.device``."""
    device = driver.resolve_device(config.device)
    params = scene.params
    num_steps = config.num_steps if config.num_steps is not None else params.max_iters
    lines: list[str] = []
    out = lines.append
    out(f"grid: {params.ny}x{params.nx}  steps: {num_steps}  storage: {config.storage}")
    out(f"device: {device} ({driver.device_name(device)})")
    try:
        _describe(out, scene, config, device, num_steps)
    except ValueError as e:
        out(f"will FAIL: {e}")
    return "\n".join(lines)


def _describe(out, scene: Scene, config, device, num_steps: int) -> None:
    variant = driver.choose_variant(scene, config, device)
    out(f"variant: {variant}"
        + ("  (auto-selected)" if resolve_variant(config.variant) == "auto" else ""))
    driver.check_config(config, variant)
    if variant == "serial":
        out("program: serial")
        out("kernel: none (host NumPy oracle, four passes a step)")
        out("segments: 1 (the whole run)")
        return
    start = 0
    if config.resume_from:
        _, start, _ = driver._load_resume(config.resume_from, scene.params, num_steps)
        out(f"resume: from step {start} of {config.resume_from}")
    remaining = num_steps - start
    observed = config.debug or config.frame_interval is not None
    ca_label = driver._check_observable(scene, config, device, variant)

    def announce(label, spc, sweep_k, chunked):
        """Print the program line (the run's Variant line: a plain run of
        a multi-step program ends in a sync tail) and return the segments."""
        segments = driver.plan_segments(config, remaining, spc, sweep_k, chunked, label)
        if ca_label is not None:
            out(f"program: {ca_label}+debug-as-sync  ({ca_label} observed per step through its "
                "bitwise-identical sync schedule)")
            return segments
        tail = 0 if observed else remaining % spc
        out(f"program: {label}" + (f"+sync-tail{tail}  (the last {tail} step(s) as an exact "
                                   "sync tail)" if tail else ""))
        return segments

    if ca_label is not None:
        sync_cfg = dataclasses.replace(config, variant="sync", staleness=None, temporal_k=None)
        segments = _sharded(out, scene, sync_cfg, device, "sync", announce)
    elif variant in SHARDED:
        segments = _sharded(out, scene, config, device, variant, announce)
    else:
        segments = _single(out, scene, config, device, variant, announce)
    out(f"segments: {len(segments)}" + (f" ({_runs(n for _, n in segments)} steps)"
                                        if segments else ""))
    if config.frame_interval is not None:
        n = -(-remaining // config.frame_interval) if remaining else 0
        out(f"frames: |u| every {config.frame_interval} steps, {n} frame(s) from step {start} "
            "into animation_data/")
    if config.debug:
        out("debug: per-step av velocity and total density, printed after the loop")
    if config.checkpoint_every is not None:
        out(f"checkpoints: every {config.checkpoint_every} steps into {config.checkpoint_dir}/ "
            f"({remaining // config.checkpoint_every} of them)")
    if config.profile_dir is not None:
        out(f"profile: torch.profiler trace of the compute bracket into "
            f"{config.profile_dir}/trace.json")
