"""K1-batch and K2-batch: the ensemble's CUDA kernels and their wrappers.

``lbm_tpu``'s ensemble (``lbm_tpu/tools/ensemble.py``) runs B variants of
one scene as one compiled program: ``_step_traced`` (:47), the jnp step
with omega and the accel weights as traced values, under ``jax.vmap``
(:117) inside one ``lax.scan`` (:128).  It reaches no ``pallas_call``; XLA
compiles the B instances into one program.  Its counterpart here runs all B
instances in one launch:

- **K1-batch** (``csrc/step.cu``): K1's step with the instance as the
  grid's third dimension, one launch a step, one reduce every
  ``_runner.TOT_BATCH`` steps.  It maps every grid.  Bound: 72 bytes of
  device memory per instance-cell-step, and a mask byte per cell (B of them
  for a geometry batch).
- **K2-batch** (``csrc/resident.cu`` on ``csrc/two_copy.cuh``): K2's
  256-step chunk with B groups of G blocks in one cooperative launch, each
  group on its own instance with K2's plan of G blocks
  (``resident_cuda.grid_plan``), the B two-copy states in L2 where they
  fit it.  It maps where B x G blocks can be resident at once.  Bound: as
  K2's, B times over.  The ensemble's kernel wherever each instance gets
  at least ``MIN_GROUP`` blocks and K11 does not take it
  (:func:`kernel_choice`).
- **K11** (``csrc/cluster.cu``): the same 256-step chunk with instance b
  run by one thread-block cluster of C blocks, its state held in the
  blocks' shared memory for the whole chunk (one copy, updated in place,
  band edges through distributed shared memory).  It maps where one
  instance fits one cluster (:func:`cluster_plan`), in waves where the B
  clusters cannot all be resident, in blocks of 1024 threads (one an SM)
  or of 512 (two an SM, where two blocks' shared memory fits it), the
  block shape and C picked together.  Bound: 92 operations a fluid
  cell-step; its tier is shared memory.

Each block reads its instance's omega, w1 and w2 from a device array into
the same ``StepParams`` fields the single kernels take, so instance b is
bitwise a single K1 (K1-batch: fields and tot_u) or K2 (K2-batch and K11:
fields; their tot_u groups the cells by their own blocks) run with b's
parameters.

Beside the kernels:

- the plain version, :func:`run_plain` (``fused_torch.run_ensemble_plain``):
  the twin step over a leading instance dimension, the CPU path and the
  card's yardstick.

Launches count in ``_build.LAUNCHES`` under ``K1-batch`` (one a step),
``K2-batch`` and ``K11`` (one a chunk; K11's block shape and C are the
runner's ``plan``).  A runner takes the plain version only for a mask on
the CPU.  For a CUDA mask it launches a kernel or raises; it never falls
back (ops/_runner.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, _runner, fused_torch, resident_cuda
from lbm_tpu_torch.params import LBMParams

KERNELS = ("K1-batch", "K2-batch", "K11")
MAX_INSTANCES = 65535  # K1-batch: the launch grid's z extent
PARTIALS_WORDS = 2**24  # cap on K1-batch's partials buffer (64 MiB)
MIN_GROUP = 3  # K2-batch's fewest blocks an instance in the policy
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # K11's blocks an instance (16: non-portable)
SMEM_MAX = 232448  # dynamic shared memory a block may take on Hopper, bytes
CLUSTER_THREADS = (1024, 512)  # K11's block shapes: one block an SM, or two
CELLS_A_THREAD = 2  # K11's tile: 2 cells a thread (csrc/cluster.cu kCells)
SUM_FLOATS = 320  # K11's warp sums by parity and a sum a step, a block
# The step models kernel_choice weighs (us a step of the whole launch),
# fitted to the 40 shapes of 64^2 to 256^2 x 1 to 600 at which K11, in
# every block shape and cluster size pinned, and K2-batch were timed in
# turns (tools/kernel_times.py --cluster-forms; NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 5).  K11 (least squares, each block shape on
# the forms the plan may take): its waves x a fixed part, the barriers,
# carries and sums, + a part per cell of an SM's bands (cluster_form).
# The two shapes cost about the same per cell of an SM; 512 threads pay
# less for a step's barriers, because the other block of the SM works
# through them.  K2-batch: the larger of a latency regime (a fixed part +
# a part per instance-cell, while its groups leave the card idle) and a
# throughput regime (the instance-cells at its tier's rate: 18.5 ps is
# 72 B at 3.9 TB/s, L2, with the B two-copy states within
# ``L2_STATE_BUDGET``; 25 ps is 2.9 TB/s, HBM, beyond it); its constants
# are the grid point of least squared log error among those that put
# every timed shape on the side it was measured on.  Five shapes held out
# of the fit and timed after it (64^2 x 200 and x 300, 128^2 x 48 and x
# 100, 256^2 x 24): the plan's form was within 2% of the fastest form at
# each (1.7% at 128^2 x 48), and K11 beat K2-batch at all five.
K11_STEP_US = {1024: 1.29, 512: 1.09}
K11_CELL_US = {1024: 1.10e-3, 512: 1.13e-3}
K2B_STEP_US = 2.1
K2B_CELL_US = 13e-6
K2B_L2_CELL_US = 18.5e-6
K2B_HBM_CELL_US = 25.0e-6


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


class ClusterPlan(NamedTuple):
    C: int  # blocks of an instance's cluster
    bands: list[tuple[int, int]]  # (first row, rows) of each rank's band
    smem: int  # dynamic shared memory a block, bytes
    resident: int  # clusters the card holds at once
    waves: int  # sets of resident clusters the card runs one after another
    us: float  # the launch's modelled step, us (K11_STEP_US, K11_CELL_US)
    threads: int  # threads a block: 1024 (one block an SM) or 512 (two)

    def label(self) -> str:
        return (f"C={self.C}, {self.threads} threads, {self.waves} "
                f"wave{'s' if self.waves > 1 else ''}")


def cluster_bands(ny: int, C: int) -> list[tuple[int, int]]:
    """K11's bands (first row, rows) of ranks 0 .. C - 1: ny // C rows each,
    the first ny mod C one more, in order (csrc/cluster.cu)."""
    base, rem = divmod(ny, C)
    return [(r * base + min(r, rem), base + (r < rem)) for r in range(C)]


def cluster_smem(hmax: int, nx: int) -> int:
    """K11's dynamic shared memory a block, bytes: hmax band rows, the rows
    below and above the band by parity and 2 carry rows, each 9 x nx
    floats, the sums, (hmax + 2) x nx mask bytes (csrc/cluster.cu
    smem_needed)."""
    return 4 * ((hmax + 6) * 9 * nx + SUM_FLOATS) + (hmax + 2) * nx


def cluster_plan(ny: int, nx: int, B: int, max_clusters=None) -> ClusterPlan | None:
    """K11's plan for B instances of ny x nx, or None where one instance
    fits no cluster (a band of ceil(ny / C) rows, its pushed rows, carries
    and mask rows above ``SMEM_MAX`` at every C; a row wider than a tile).

    ``max_clusters(C, smem, threads)`` gives the clusters of C blocks of
    ``threads`` threads and ``smem`` bytes the card holds at once
    (``lbm_cluster_batch_max_clusters``; None: all B at once; 0: none of
    that size).  Of the block shapes (``CLUSTER_THREADS``) and sizes that
    fit, the plan takes the pair with the least modelled step
    (:func:`cluster_form`).  512 threads are taken only where two blocks
    share an SM: the first wave holds more clusters than the card holds of
    1024 threads, one block an SM (where two blocks' shared memory does not
    fit an SM, the card holds no more); alone on an SM a block of 512 does
    the work of one of 1024 with half the warps.  The smaller C, then the
    larger block, wins a tie."""
    best = None
    for threads in CLUSTER_THREADS:
        for C in CLUSTER_SIZES:
            plan = cluster_form(ny, nx, B, C, threads, max_clusters)
            if plan is None or threads == 512 and min(B, plan.resident) <= alone(
                    C, plan.smem, B, max_clusters):
                continue
            if best is None or plan.us < best.us or (plan.us == best.us and C < best.C):
                best = plan
    return best


def alone(C: int, smem: int, B: int, max_clusters=None) -> int:
    """The clusters of C blocks of ``smem`` bytes the card holds one block
    an SM: those of 1024 threads (all B without the card's query)."""
    return B if max_clusters is None else max_clusters(C, smem, 1024)


def cluster_form(ny: int, nx: int, B: int, C: int, threads: int, max_clusters=None
                 ) -> ClusterPlan | None:
    """K11's plan for B instances of ny x nx pinned to clusters of C blocks
    of ``threads`` threads (:func:`cluster_plan`'s candidate, whether its
    blocks share SMs or not), or None where the band does not fit a block
    or the card holds no such cluster.

    Its modelled step (``us``): the waves of ``resident`` clusters, each
    ``K11_STEP_US`` (the barriers, carries and sums) + ``K11_CELL_US`` x
    the cells of its fullest SM, each shape with its own constants.  A
    block of 1024 threads has an SM to itself, so an SM's cells are its
    band; a wave of 512-thread blocks puts two bands on an SM where it
    holds more clusters than the card holds one block an SM
    (:func:`alone`), one band where it holds no more (the last wave of a
    launch, or the only one)."""
    if C > ny or nx > CELLS_A_THREAD * threads:
        return None
    hmax = -(-ny // C)
    smem = cluster_smem(hmax, nx)
    if smem > SMEM_MAX:
        return None
    resident = B if max_clusters is None else max_clusters(C, smem, threads)
    if resident < 1:
        return None
    waves = -(-B // resident)
    bands = 0  # bands on the fullest SM, summed over the waves
    for w in range(waves):
        held = min(resident, B - w * resident)
        bands += 2 if threads == 512 and held > alone(C, smem, B, max_clusters) else 1
    cost = waves * K11_STEP_US[threads] + K11_CELL_US[threads] * bands * hmax * nx
    return ClusterPlan(C, cluster_bands(ny, C), smem, resident, waves, cost, threads)


def k2_batch_us(ny: int, nx: int, B: int) -> float:
    """K2-batch's modelled step of B instances of ny x nx, us: the larger of
    ``K2B_STEP_US`` + the instance-cells x ``K2B_CELL_US`` and the
    instance-cells x ``K2B_L2_CELL_US`` (two copies of the B states within
    ``resident_cuda.L2_STATE_BUDGET``) or ``K2B_HBM_CELL_US``."""
    cells = B * ny * nx
    in_l2 = 2 * 9 * 4 * cells <= resident_cuda.L2_STATE_BUDGET
    return max(K2B_STEP_US + cells * K2B_CELL_US,
               cells * (K2B_L2_CELL_US if in_l2 else K2B_HBM_CELL_US))


def kernel_choice(ny: int, nx: int, B: int, resident: int, max_clusters=None) -> str:
    """The kernel an ensemble of B (9, ny, nx) float32 states runs on: K11
    where :func:`cluster_plan` maps it with ``max_clusters`` (the card's
    query; None: K11 is not considered) and its modelled step is shorter
    than K2-batch's (:func:`k2_batch_us`); else K2-batch where each
    instance gets at least ``MIN_GROUP`` blocks (G of :func:`group_blocks`,
    with ``resident`` blocks resident at once) and 9 planes stay within
    32-bit offsets; else K1-batch.

    K11 against K2-batch, in turns (``tools/kernel_times.py
    --cluster-forms``; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
    5): of 39 shapes from 64^2 to 256^2 and 1 to 500 instances, K11 in the
    form its plan takes took less time at 32 and more at 7: 256^2 x 1, 2,
    4, 8 and 9 (one wave holding 1-4 of the 7 clusters of 16 the card
    holds; two waves of 14 places for 8 or 9 instances), 128^2 x 1 (one
    cluster of 16) and x 16 (two waves of clusters of 16, 512 threads).
    The two models put every one of the 39 on the side it was measured
    on; the closest calls were 128^2 x 1 and x 16 (K2-batch 1.7% and 2.1%
    faster), 256^2 x 5 and 128^2 x 33 (K11 4.6% and 4.9%).  Where
    K1-batch runs instead of K2-batch (G under 3: B from 177), K11 is held
    to the same model, which K1-batch's times lay within 5% of there
    (64^2 x 500, in the earlier turns).

    K2-batch against K1-batch (the earlier turns): K2-batch took 27-38% less
    time than K1-batch where the B two-copy states fit the L2 budget
    (``resident_cuda.L2_STATE_BUDGET``) and 11-19% less beyond it, at every
    shape timed with G from 3 (64^2 x 149) to 132 (2048^2 x 4).  With one
    or two blocks an instance it won no more: 128^2 x 250 (G = 2) tied,
    K1-batch took 3-13% less at 128^2 x 300, 256^2 x 200 and x 400, and
    3.5% more at 64^2 x 500 (G = 1).  So K1-batch runs from G = 2 down,
    where B exceeds the resident blocks (528 on the H100), and where a grid
    exceeds the offsets."""
    if max_clusters is not None:
        plan = cluster_plan(ny, nx, B, max_clusters)
        if plan is not None and plan.us < k2_batch_us(ny, nx, B):
            return "K11"
    if group_blocks(ny, nx, B, resident) >= MIN_GROUP and 9 * ny * nx < 2**31:
        return "K2-batch"
    return "K1-batch"


_CARD_CLUSTERS: dict = {}  # card_clusters' queries by (library, device)


def card_clusters(lib, device: int):
    """``max_clusters(C, smem, threads)`` of the card
    (``lbm_cluster_batch_max_clusters``), asked once a process per size,
    shared size and shape for each library and device; raises on a failed
    query."""
    if (lib, device) in _CARD_CLUSTERS:
        return _CARD_CLUSTERS[lib, device]
    known = {}

    def max_clusters(C: int, smem: int, threads: int) -> int:
        if (C, smem, threads) not in known:
            n = lib.lbm_cluster_batch_max_clusters(C, smem, threads, device)
            if n < 0:
                raise RuntimeError(f"K11: the card refused the occupancy query of clusters "
                                   f"of {C} blocks of {threads} threads with {smem} bytes of "
                                   "shared memory")
            known[C, smem, threads] = n
        return known[C, smem, threads]

    _CARD_CLUSTERS[lib, device] = max_clusters
    return max_clusters


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

    On a CPU mask: the plain version.  On a CUDA mask: K11, K2-batch or
    K1-batch (:func:`kernel_choice`; ``kernel`` forces one, and raises where
    it cannot map), buffers allocated here, once; the returned state is one
    of the runner's buffers and stays valid until its next call.  ``f0_b``
    is not modified.  ``run_all.kernel`` names what runs (``plain`` on the
    CPU), ``run_all.plan`` K11's :class:`ClusterPlan` (None for the other
    kernels).  ``lib`` is the kernel library (``_build.load()`` by
    default)."""
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

    planes = tuple(torch.from_numpy(a) for a in (om, w1, w2))

    def plain(f_b):
        check(f_b)
        return fused_torch.run_ensemble_plain(f_b, obstacles, *planes, params.accel_row,
                                              num_steps)

    chosen, plan = "plain", None

    def card(lib):
        nonlocal chosen, plan
        ny, nx = params.ny, params.nx
        if B > MAX_INSTANCES:
            raise ValueError(f"{B} instances: the ensemble kernels take at most "
                             f"{MAX_INSTANCES}")
        state_bytes = 2 * B * 9 * ny * nx * 4
        total = torch.cuda.get_device_properties(dev).total_memory
        if state_bytes > total:
            raise ValueError(f"two copies of {B} {ny}x{nx} float32 states ({state_bytes} "
                             f"bytes) exceed the card's {total} bytes")
        resident = _runner.cooperative_grid(lib, "lbm_resident_batch_blocks", "K2-batch", dev)
        clusters = card_clusters(lib, dev.index)
        chosen = kernel or kernel_choice(ny, nx, B, resident, clusters)
        if chosen == "K11":
            plan = cluster_plan(ny, nx, B, clusters)
            if plan is None:
                raise ValueError(f"K11 cannot map {ny}x{nx}: one instance fits no cluster of "
                                 f"at most {CLUSTER_SIZES[-1]} blocks")
        if chosen == "K2-batch":
            if group_blocks(ny, nx, B, resident) < 1:
                raise ValueError(f"K2-batch cannot map {B} instances: at most {resident} "
                                 "blocks are resident at once")
            if 9 * ny * nx >= 2**31:
                raise ValueError(f"K2-batch cannot map {ny}x{nx}: 9 planes exceed 32-bit "
                                 "offsets")
        fa = torch.empty(shape, dtype=torch.float32, device=dev)
        fb = torch.empty_like(fa)
        sc = torch.from_numpy(np.stack([om, w1, w2], axis=1).copy()).to(dev)
        mask_stride = ny * nx if obstacles.dim() == 3 else 0
        chunks = _runner.chunk_lengths(num_steps, resident_cuda.DEFAULT_CHUNK)
        if chosen == "K1-batch":
            nblocks = lib.lbm_step_blocks(ny, nx)
            batch = max(1, min(_runner.TOT_BATCH, num_steps,
                               PARTIALS_WORDS // (B * nblocks)))
            partials = torch.empty((batch, B, nblocks), dtype=torch.float32, device=dev)
        elif chosen == "K2-batch":
            G = group_blocks(ny, nx, B, resident)
            partials, words = batch_partials(ny, nx, B, G, max(chunks, default=1))
            partials = partials.to(dev)

        def run_all(f_b):
            tot = torch.empty((num_steps, B), dtype=torch.float32, device=dev)
            if num_steps == 0:
                return f_b, tot
            fa.copy_(f_b)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if chosen == "K1-batch":
                _build.launch(
                    lib, "lbm_step_batch_run", "K1-batch", fa.data_ptr(), fb.data_ptr(),
                    obstacles.data_ptr(), mask_stride, sc.data_ptr(), partials.data_ptr(),
                    tot.data_ptr(), ny, nx, params.accel_row, B, num_steps, batch, stream,
                    dev.index, n=num_steps)
                return (fb if num_steps % 2 else fa), tot
            src, dst, done = fa, fb, 0
            for n in chunks:
                if chosen == "K11":
                    # The state ends in dst for an odd n, in src for an even one.
                    _build.launch(
                        lib, "lbm_cluster_batch_chunk", "K11", src.data_ptr(),
                        (dst if n % 2 else src).data_ptr(), obstacles.data_ptr(), mask_stride,
                        sc.data_ptr(), tot.data_ptr() + 4 * done * B, ny, nx, params.accel_row,
                        n, plan.C, B, plan.smem, plan.threads, stream, dev.index)
                else:
                    _build.launch(
                        lib, "lbm_resident_batch_chunk", "K2-batch", src.data_ptr(),
                        dst.data_ptr(), obstacles.data_ptr(), mask_stride, sc.data_ptr(),
                        partials.data_ptr(), words, tot.data_ptr() + 4 * done * B, ny, nx,
                        params.accel_row, n, G, B, stream, dev.index)
                if n % 2:
                    src, dst = dst, src
                done += n
            return src, tot

        return run_all

    run_all = _runner.card_or_plain(params, obstacles, plain, card, lib=lib, check=check)
    run_all.kernel, run_all.plan = chosen, plan
    return run_all
