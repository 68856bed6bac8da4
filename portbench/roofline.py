"""The frozen counts of a job's work and the published peaks of the card.

A job's least time is the larger of its operations over the float32 rate
outside the tensor cores and its compulsory bytes over the memory rate.
Operations: 92 a fluid cell-step, counted from the cell update of the
program's kernels (moments 23, equilibria 40, relaxation 27, |u| 2; walls
only move values), as ``lbm_tpu_torch/tools/kernel_times.py`` counts them.
Compulsory bytes: the initial state and the wall mask read once, the final
state and the per-step sums written once.  A step's 73 bytes of state
traffic are not compulsory: an L2-resident kernel keeps the state on chip
between steps, and charging them to device memory would read above 100%.
"""

from __future__ import annotations

from typing import NamedTuple

OPS_PER_FLUID_CELL_STEP = 92
# One NVIDIA H100 SXM at 700 W (NVIDIA's data sheet).
PEAK_OPS_PER_S = 67e12  # float32, outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


class Work(NamedTuple):
    """One job: ``instances`` states of ``cells`` cells (``fluid`` of them
    fluid), ``steps`` steps, ``value_bytes`` a stored value, ``mask_cells``
    mask bytes read."""
    instances: int
    cells: int
    fluid: int
    steps: int
    value_bytes: int = 4
    mask_cells: int = 0

    @property
    def ops(self) -> int:
        return OPS_PER_FLUID_CELL_STEP * self.fluid * self.steps * self.instances

    @property
    def bytes(self) -> int:
        state = 9 * self.cells * self.value_bytes * self.instances
        return 2 * state + self.mask_cells + 4 * self.steps * self.instances


def bound_seconds(work: Work) -> tuple[float, str]:
    """(least seconds of the job, "operations" or "bytes")."""
    t_ops = work.ops / PEAK_OPS_PER_S
    t_bytes = work.bytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
