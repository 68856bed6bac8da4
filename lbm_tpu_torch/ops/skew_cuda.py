"""K5: the skewed K-step temporal sweep (csrc/skew.cu) and its wrappers.

Replaces ``lbm_tpu/ops/skew_pallas.py::_skew_kernel`` (:211, entries
``make_pair`` :529 and ``make_run_all`` :597), float32 state (K5) and int16
state (K5-i16, ``storage="i16"``).  One launch advances the grid K steps:
each block walks a band of rows of a column strip upward, keeping the last
rows of every level in shared memory, so every row of every level is
computed once per band and the state crosses device memory once per K
steps.  Level K is written at its true position, so each sweep is K steps
on the canonical state: the TPU's rotated forward sweep and mirrored
reverse sweep have no counterpart (the note at the top of csrc/skew.cu).
``make_run_all`` runs whole sweeps, then the remainder as K1 (or K1-i16)
steps.

Beside the kernel:

- the plain version, :func:`run_plain`: ``fused_torch.run_sweeps`` (as
  K4's), which the kernel matches bitwise on fields;
- ``LAUNCHES`` (f32) and ``LAUNCHES_I16`` (int16): the number of sweep
  launches so far, raised only where the kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import quant, temporal_cuda
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0
LAUNCHES_I16 = 0

THREADS = 256  # threads per K5 block (kT in csrc/skew.cu)
MAX_PRE = 6  # level-0 values a thread loads per walk step (kMaxPre)
MAX_ITEMS = 4  # cells a thread computes per walk step (kMaxItems)
# Output columns of a strip and rows of a band: the fastest of eight shapes
# (32-120 columns, 64-512 rows) timed in turns at K = 4 at 2048^2 and
# 4096^2, f32 and int16 (PERF.md, Findings).
STRIP_W = 64
BAND_H = 128

run_plain = temporal_cuda.run_plain


def smem_bytes(K: int, tw: int, bh: int) -> int | None:
    """Dynamic shared memory of one K5 block (strip_smem in csrc/skew.cu),
    or None for a strip wider than a walk step's level-0 loads or cells
    cover."""
    cw, rows = tw + 2 * K, bh + 2 * K
    if 9 * cw > THREADS * MAX_PRE or K * cw - K * (K + 1) > THREADS * MAX_ITEMS:
        return None
    return K * 4 * 9 * cw * 4 + THREADS * 4 + cw * 4 + rows * cw + rows


def supports(params: LBMParams, K: int, storage: str = "f32") -> bool:
    """True when K5 can map a K-deep sweep of this grid: K >= 2, ny and nx
    at least 2K (the warm-up rows of B6's seam strip), and a strip that fits
    shared memory.  The driven row may lie anywhere."""
    quant.check_storage(storage)
    if K < 2 or params.ny < 2 * K or params.nx < 2 * K:
        return False
    need = smem_bytes(K, STRIP_W, BAND_H)
    return need is not None and need <= temporal_cuda.SMEM_LIMIT


def _count(i16: bool, n: int) -> None:
    global LAUNCHES, LAUNCHES_I16
    if i16:
        LAUNCHES_I16 += n
    else:
        LAUNCHES += n


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32"):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: K5 sweeps, then K1
    steps for ``num_steps mod K`` (``skew_pallas.make_run_all`` takes pairs
    of 2K steps; a sweep here is K)."""
    if not supports(params, K, storage):
        raise ValueError(f"skewed sweep (K={K}) cannot map a {params.ny}x{params.nx} grid")
    return temporal_cuda.sweep_runner("K5 skewed sweep kernel", "skew", (STRIP_W, BAND_H),
                                      _count, params, obstacles, num_steps, K, storage)


def make_sweep(params: LBMParams, obstacles: torch.Tensor, K: int, storage: str = "f32"):
    """Build ``f -> (f_after_K_steps, tot_u (K,))``: one K5 launch."""
    return make_run_all(params, obstacles, K, K, storage)
