"""What a run refuses to run without, or with: a CUDA card for each chip the
cell asks for, and no JAX in the process.

The JAX package (``lbm_tpu``) is the port's reference on the CPU and is
never measured.  Modules are compared by their top-level name, the part
before the first dot, whole: ``lbm_tpu_torch`` is not ``lbm_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lbm_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def missing_cards(chips: int) -> str | None:
    """Why the run cannot have ``chips`` CUDA cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA device(s), the cell needs {chips}"
    return None
