"""Solver-variant registry.

| name    | lbm_tpu counterpart | execution                                           |
|---------|---------------------|-----------------------------------------------------|
| serial  | serial              | host NumPy oracle (ground truth)                    |
| torch   | jnp                 | plain PyTorch twin step, any device                 |
| cuda    | pallas              | CUDA kernels: multi-step resident (K2) or step (K1) |

``auto`` picks ``cuda`` on a CUDA device and ``torch`` on the CPU.  The
aliases ``jnp`` -> ``torch`` and ``pallas`` -> ``cuda`` let commands written
for ``lbm_tpu`` carry over.  The sharded variants of ``lbm_tpu`` (sync,
overlap, async, async-k, chunked, ca) are not ported yet and say so.
"""

from __future__ import annotations

import dataclasses


class NotPortedError(ValueError):
    """A feature of ``lbm_tpu`` that this package does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} not yet ported to lbm_tpu_torch")


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    name: str
    lbm_tpu_analog: str
    description: str


VARIANTS: dict[str, VariantSpec] = {
    "serial": VariantSpec(
        "serial", "serial", "Host NumPy oracle; 4 separate passes per step. Ground truth."
    ),
    "torch": VariantSpec(
        "torch", "jnp", "Plain PyTorch fused step (the twin every kernel is held to)."
    ),
    "cuda": VariantSpec(
        "cuda",
        "pallas",
        "Hand-written CUDA kernels: the persistent multi-step kernel where two "
        "state copies fit L2, else a loop of the one-step kernel.",
    ),
}

_ALIASES = {
    "jnp": "torch",
    "openmp": "torch",
    "fused": "torch",
    "pallas": "cuda",
    "auto": "auto",
}

_NOT_PORTED = {
    "sync", "overlap", "async", "async-k", "chunked", "ca",
    "mpi", "waitall", "semi-async", "testall", "stale", "testall-complex",
}


def resolve_variant(name: str) -> str:
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotPortedError(f"sharded variant {name!r} is")
    name = _ALIASES.get(name, name)
    if name != "auto" and name not in VARIANTS:
        raise ValueError(
            f"unknown variant {name!r}; available: {sorted(VARIANTS)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return name
