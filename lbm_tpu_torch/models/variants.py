"""Solver-variant registry.

| name    | lbm_tpu counterpart | execution                                           |
|---------|---------------------|-----------------------------------------------------|
| serial  | serial              | host NumPy oracle (ground truth)                    |
| torch   | jnp                 | plain PyTorch twin step, any device                 |
| cuda    | pallas              | CUDA kernels: K2, K3 (in place), the K-step sweeps |
|         |                     | K5 (skew) / K4 (trapezoid), or a K1 loop; i16      |
| sync    | sync                | row shards, exchange then K1-slab per shard         |
| overlap | overlap             | row shards, interior rows while the exchange flies  |
| async   | async               | row shards, ghosts one step old (k with staleness)  |
| async-k | async-k             | row shards, ghosts k steps old (default k = 2)      |
| chunked | chunked             | row shards, k steps per exchange (K6 where it maps) |
| ca      | ca                  | row shards, K ghost rows per K steps, exact sweeps  |

``auto`` picks ``cuda`` on a CUDA device and ``torch`` on the CPU, and on
more than one device the sharded rule of ``lbm_tpu``'s driver
(models/driver.py).  The aliases ``jnp`` -> ``torch`` and ``pallas`` ->
``cuda``, and ``lbm_tpu``'s ``mpi`` -> sync, ``waitall`` / ``semi-async``
-> overlap, ``testall`` / ``stale`` -> async and ``testall-complex`` ->
async-k, let commands written for ``lbm_tpu`` carry over.  The sharded
variants run on a row mesh of devices (parallel/mesh.py; ``--host-devices
N`` makes one device count as N).
"""

from __future__ import annotations

import dataclasses


class NotPortedError(ValueError):
    """A feature of ``lbm_tpu`` that this package does not have yet."""

    def __init__(self, what: str, hint: str = ""):
        super().__init__(f"{what} not yet ported to lbm_tpu_torch" + (f"; {hint}" if hint else ""))


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    name: str
    lbm_tpu_analog: str
    description: str
    sharded: bool = False


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
        "state copies fit L2, the in-place one where one copy fits, else the "
        "K-step temporal sweeps (skewed or trapezoid) or a loop of the one-step "
        "kernel; f32 or i16 storage.",
    ),
    "sync": VariantSpec(
        "sync", "sync", "Row-sharded; the halo exchange completes before any compute.",
        True,
    ),
    "overlap": VariantSpec(
        "overlap", "overlap",
        "Row-sharded; interior rows compute while the halos are copied on a side "
        "stream, then the two boundary rows.", True,
    ),
    "async": VariantSpec(
        "async", "async",
        "Row-sharded; boundary rows use halos one step old (k with --staleness), the "
        "exchange overlapping the whole step.", True,
    ),
    "async-k": VariantSpec(
        "async-k", "async-k", "Row-sharded; an explicit halo queue of age k (default 2).",
        True,
    ),
    "chunked": VariantSpec(
        "chunked", "chunked",
        "Row-sharded; halos exchanged every k steps, k local steps between exchanges "
        "(the ghosted chunk kernel where the shard fits L2).", True,
    ),
    "ca": VariantSpec(
        "ca", "ca",
        "Row-sharded, exact and communication-avoiding: K ghost rows exchanged every K "
        "steps, then one K-step sweep per shard (K4-slab, K7 or K8); fields equal sync's.",
        True,
    ),
}

SHARDED = tuple(name for name, spec in VARIANTS.items() if spec.sharded)

_ALIASES = {
    "jnp": "torch",
    "openmp": "torch",
    "fused": "torch",
    "pallas": "cuda",
    "mpi": "sync",
    "waitall": "overlap",
    "semi-async": "overlap",
    "testall": "async",
    "stale": "async",
    "testall-complex": "async-k",
    "auto": "auto",
}

def resolve_variant(name: str) -> str:
    name = name.lower()
    name = _ALIASES.get(name, name)
    if name != "auto" and name not in VARIANTS:
        raise ValueError(
            f"unknown variant {name!r}; available: {sorted(VARIANTS)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return name
