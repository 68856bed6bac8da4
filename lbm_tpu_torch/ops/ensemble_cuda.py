"""K1-batch and K2-batch: the ensemble's CUDA kernels and their wrappers.

``lbm_tpu``'s ensemble (``lbm_tpu/tools/ensemble.py``) runs B variants of
one scene as one compiled program: ``_step_traced`` (:47), the jnp step
with omega and the accel weights as traced values, under ``jax.vmap``
(:117) inside one ``lax.scan`` (:128).  It reaches no ``pallas_call``; XLA
compiles the B instances into one program.  Its counterpart here runs all B
instances in one launch:

- **K1-batch** (``csrc/step.cu``): K1's step with the instance as the
  grid's third dimension, one launch a step, one reduce every
  ``fused_cuda.TOT_BATCH`` steps.  It maps every grid.  Bound: 72 bytes of
  device memory per instance-cell-step, and a mask byte per cell (B of them
  for a geometry batch).
- **K2-batch** (``csrc/resident.cu`` on ``csrc/two_copy.cuh``): K2's
  256-step chunk with B groups of G blocks in one cooperative launch, each
  group on its own instance with K2's plan of G blocks
  (``resident_cuda.grid_plan``), the B two-copy states in L2 where they
  fit it.  It maps where B x G blocks can be resident at once.  Bound: as
  K2's, B times over.  The ensemble's default wherever each instance gets
  at least ``MIN_GROUP`` blocks (:func:`kernel_choice`).

Each block reads its instance's omega, w1 and w2 from a device array into
the same ``StepParams`` fields the single kernels take, so instance b is
bitwise a single K1 (K1-batch: fields and tot_u) or K2 (K2-batch: fields;
its tot_u groups the cells by its own G) run with b's parameters.

Beside the kernels:

- the plain version, :func:`run_plain` (``fused_torch.run_ensemble_plain``):
  the twin step over a leading instance dimension, the CPU path and the
  card's yardstick;
- ``LAUNCHES_BATCH`` (K1-batch step launches) and
  ``LAUNCHES_BATCH_RESIDENT`` (K2-batch chunk launches), raised only where
  a kernel launches.

A runner takes the plain version only for a mask on the CPU.  For a CUDA
mask it launches a kernel or raises; it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch, resident_cuda
from lbm_tpu_torch.params import LBMParams

LAUNCHES_BATCH = 0
LAUNCHES_BATCH_RESIDENT = 0

KERNELS = ("K1-batch", "K2-batch")
MAX_INSTANCES = 65535  # K1-batch: the launch grid's z extent
PARTIALS_WORDS = 2**24  # cap on K1-batch's partials buffer (64 MiB)
MIN_GROUP = 3  # K2-batch's fewest blocks an instance in the policy


def scalars(params: LBMParams, omegas, accels=None) -> tuple[np.ndarray, np.ndarray,
                                                              np.ndarray]:
    """(omegas, w1s, w2s), (B,) float32 arrays: ``accels`` None gives every
    instance ``params.accel``; the weights as ``lbm_tpu``'s ensemble
    computes them (``fused_torch.ensemble_weights``)."""
    om = np.atleast_1d(np.asarray(omegas, dtype=np.float32))
    if om.ndim != 1 or om.size == 0:
        raise ValueError("omegas must be a non-empty 1-D sequence")
    ac = (np.full(om.size, params.accel, dtype=np.float32) if accels is None
          else np.asarray(accels, dtype=np.float32))
    if ac.shape != om.shape:
        raise ValueError(f"accels must have shape {om.shape}, got {ac.shape}")
    w1, w2 = fused_torch.ensemble_weights(params.density, ac)
    return om, w1, w2


def run_plain(f_b: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, omegas,
              accels, num_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of both kernels: ``num_steps`` batched twin steps
    on ``f_b``'s device; returns (f_b, tot (num_steps, B))."""
    om, w1, w2 = (torch.from_numpy(a).to(f_b.device) for a in scalars(params, omegas, accels))
    return fused_torch.run_ensemble_plain(f_b, obstacles, om, w1, w2, params.accel_row,
                                          num_steps)


def group_blocks(ny: int, nx: int, B: int, resident: int) -> int:
    """G, K2-batch's blocks per instance: K2's one per 256 cells, at most
    ``resident`` // B (the cooperative launch's limit); 0 where B exceeds
    ``resident``."""
    return min(-(-ny * nx // 256), resident // B)


def batch_partials(ny: int, nx: int, B: int, G: int, chunk: int) -> tuple[torch.Tensor, int]:
    """(K2-batch's partials buffer on the CPU, its words per instance):
    instance b's slice at b x words is K2's buffer for a grid of G blocks
    (``resident_cuda.partials_buffer`` of ``resident_cuda.grid_plan(ny,
    nx, G)``: G step counters, zero; the plan; chunk x G sums)."""
    one = resident_cuda.partials_buffer(resident_cuda.grid_plan(ny, nx, G), chunk, "cpu")
    return one.repeat(B), one.numel()


def batch_waits(plan, B: int) -> list[set[int]]:
    """The host model of K2-batch's waits: for each block of the launch
    (instance b's G blocks at b x G ..), the blocks its step waits on.  A
    block takes its group's plan entry and waits on ``dep_n`` counters from
    ``dep_lo`` cyclically modulo G from the group's base
    (csrc/two_copy.cuh ``wait_blocks`` on the group's counters), so every
    wait stays inside its instance."""
    steps = plan[0]
    G = len(steps)
    return [{b * G + (lo + d) % G for d in range(n)}
            for b in range(B) for _, _, lo, n in steps]


def kernel_choice(ny: int, nx: int, B: int, resident: int) -> str:
    """The kernel an ensemble of B (9, ny, nx) float32 states runs on:
    K2-batch where each instance gets at least ``MIN_GROUP`` blocks (G of
    :func:`group_blocks`, with ``resident`` blocks resident at once) and 9
    planes stay within 32-bit offsets, else K1-batch.

    In turns (``tools/kernel_times.py --ensemble``; NVIDIA H100 80GB HBM3,
    700.00 W; PERF.md section 5), K2-batch took 27-38% less time than
    K1-batch where the B two-copy states fit the L2 budget
    (``resident_cuda.L2_STATE_BUDGET``) and 11-19% less beyond it, at every
    shape timed with G from 3 (64^2 x 149) to 132 (2048^2 x 4).  With one
    or two blocks an instance it won no more: 128^2 x 250 (G = 2) tied,
    K1-batch took 3-13% less at 128^2 x 300, 256^2 x 200 and x 400, and
    3.5% more at 64^2 x 500 (G = 1).  So K1-batch runs from G = 2 down,
    where B exceeds the resident blocks (528 on the H100), and where a grid
    exceeds the offsets."""
    if group_blocks(ny, nx, B, resident) >= MIN_GROUP and 9 * ny * nx < 2**31:
        return "K2-batch"
    return "K1-batch"


def _check_mask(obstacles: torch.Tensor, params: LBMParams, B: int) -> None:
    shape = tuple(obstacles.shape)
    if obstacles.dtype != torch.bool or not obstacles.is_contiguous():
        raise ValueError("obstacle mask must be a contiguous bool tensor")
    if shape not in ((params.ny, params.nx), (B, params.ny, params.nx)):
        raise ValueError(f"obstacle mask shape {shape} != ({params.ny}, {params.nx}) or "
                         f"({B}, {params.ny}, {params.nx})")


def make_run_all(params: LBMParams, obstacles: torch.Tensor, omegas, accels=None,
                 num_steps: int = 0, kernel: str | None = None, lib=None):
    """Build ``f0_b -> (f_b, tot (num_steps, B))`` for B instances of one
    grid: omega ``omegas[b]`` and accel ``accels[b]`` (default
    ``params.accel``), ``obstacles`` (ny, nx) bool shared by every instance
    or (B, ny, nx) for a geometry batch, ``f0_b`` (B, 9, ny, nx) float32.

    On a CPU mask: the plain version.  On a CUDA mask: K1-batch or K2-batch
    (:func:`kernel_choice`; ``kernel`` forces one, and raises where it
    cannot map), buffers allocated here, once; the returned state is one
    of the runner's buffers and stays valid until its next call.  ``f0_b``
    is not modified.  ``run_all.kernel`` names what runs (``plain`` on the
    CPU).  ``lib`` is the kernel library (``_build.load()`` by default)."""
    om, w1, w2 = scalars(params, omegas, accels)
    B = om.size
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"unknown ensemble kernel {kernel!r}; use one of {KERNELS}")
    _check_mask(obstacles, params, B)
    shape = (B, 9, params.ny, params.nx)
    dev = obstacles.device

    def check(f_b):
        if f_b.device != dev:
            raise ValueError(f"states on {f_b.device} but obstacle mask on {dev}")
        if f_b.dtype != torch.float32 or not f_b.is_contiguous() or tuple(f_b.shape) != shape:
            raise ValueError(f"states must be a contiguous float32 tensor of shape {shape}")

    if dev.type == "cpu":
        planes = tuple(torch.from_numpy(a) for a in (om, w1, w2))

        def run_all_plain(f_b):
            check(f_b)
            return fused_torch.run_ensemble_plain(f_b, obstacles, *planes, params.accel_row,
                                                  num_steps)

        run_all_plain.kernel = "plain"
        return run_all_plain
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}; use cuda or cpu")

    lib = lib or _build.load()
    ny, nx = params.ny, params.nx
    if B > MAX_INSTANCES:
        raise ValueError(f"{B} instances: the ensemble kernels take at most {MAX_INSTANCES}")
    state_bytes = 2 * B * 9 * ny * nx * 4
    total = torch.cuda.get_device_properties(dev).total_memory
    if state_bytes > total:
        raise ValueError(f"two copies of {B} {ny}x{nx} float32 states ({state_bytes} bytes) "
                         f"exceed the card's {total} bytes")
    resident = lib.lbm_resident_batch_blocks(dev.index)
    if resident <= 0:
        raise RuntimeError(f"K2-batch cannot be launched cooperatively on "
                           f"{torch.cuda.get_device_name(dev)}")
    chosen = kernel or kernel_choice(ny, nx, B, resident)
    if chosen == "K2-batch":
        if group_blocks(ny, nx, B, resident) < 1:
            raise ValueError(f"K2-batch cannot map {B} instances: at most {resident} blocks "
                             "are resident at once")
        if 9 * ny * nx >= 2**31:
            raise ValueError(f"K2-batch cannot map {ny}x{nx}: 9 planes exceed 32-bit offsets")
    fa = torch.empty(shape, dtype=torch.float32, device=dev)
    fb = torch.empty_like(fa)
    sc = torch.from_numpy(np.stack([om, w1, w2], axis=1).copy()).to(dev)
    mask_stride = ny * nx if obstacles.dim() == 3 else 0
    if chosen == "K1-batch":
        nblocks = lib.lbm_step_blocks(ny, nx)
        batch = max(1, min(fused_cuda.TOT_BATCH, num_steps, PARTIALS_WORDS // (B * nblocks)))
        partials = torch.empty((batch, B, nblocks), dtype=torch.float32, device=dev)
    else:
        G = group_blocks(ny, nx, B, resident)
        chunk = max(1, min(resident_cuda.DEFAULT_CHUNK, num_steps))
        partials, words = batch_partials(ny, nx, B, G, chunk)
        partials = partials.to(dev)

    def run_all(f_b):
        global LAUNCHES_BATCH, LAUNCHES_BATCH_RESIDENT
        check(f_b)
        tot = torch.empty((num_steps, B), dtype=torch.float32, device=dev)
        if num_steps == 0:
            return f_b, tot
        fa.copy_(f_b)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if chosen == "K1-batch":
            rc = lib.lbm_step_batch_run(
                fa.data_ptr(), fb.data_ptr(), obstacles.data_ptr(), mask_stride, sc.data_ptr(),
                partials.data_ptr(), tot.data_ptr(), ny, nx, params.accel_row, B, num_steps,
                batch, stream, dev.index)
            _build.check(rc, "K1-batch step kernel")
            LAUNCHES_BATCH += num_steps
            return (fb if num_steps % 2 else fa), tot
        src, dst, done = fa, fb, 0
        while done < num_steps:
            n = min(chunk, num_steps - done)
            rc = lib.lbm_resident_batch_chunk(
                src.data_ptr(), dst.data_ptr(), obstacles.data_ptr(), mask_stride,
                sc.data_ptr(), partials.data_ptr(), words, tot.data_ptr() + 4 * done * B, ny,
                nx, params.accel_row, n, G, B, stream, dev.index)
            _build.check(rc, "K2-batch resident kernel")
            LAUNCHES_BATCH_RESIDENT += 1
            if n % 2:
                src, dst = dst, src
            done += n
        return src, tot

    run_all.kernel = chosen
    return run_all
