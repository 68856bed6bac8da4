"""int16 fixed-point deviation storage for the distribution state.

The torch counterpart of ``lbm_tpu/ops/quant.py``: the state is stored as
``q = round((f - w_k*rho0) * s_k)`` with the per-plane scale
``s_k = 32767 / (RANGE_C * w_k * rho0)``, clamped to +-32767 (stores
saturate rather than wrap).  Half the bytes of f32 per value; all
arithmetic stays float32, the codec wraps only loads and stores.

The constants are computed on the host exactly as the reference computes
them: ``s_k`` and ``rest_k`` in float64, then rounded to float32; the
dequantize multiplier is the float32 rounding of the float64 reciprocal of
the float32 scale.  :func:`codec_constants` hands the same float32 values
to the CUDA kernels (csrc/lbm_common.cuh), whose ``rintf`` rounds half to
even like ``torch.round``, so kernel and plain version quantize bitwise
alike.  Dequantize is a multiply and an add, two roundings, never an FMA.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.core import lattice

# Representable deviation range, in units of the rest distribution w_k*rho0.
RANGE_C = 2.0
_QMAX = 32767.0

STORAGES = ("f32", "i16")


def check_storage(storage: str) -> None:
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; use 'f32' or 'i16'")


def plane_scales(density: float) -> np.ndarray:
    """Per-plane quantization scale s_k (float32, shape (9,)):
    q = round((f_k - w_k*density) * s_k)."""
    w = np.asarray(lattice.WEIGHTS, dtype=np.float64) * float(density)
    return (_QMAX / (RANGE_C * w)).astype(np.float32)


def plane_rest(density: float) -> np.ndarray:
    """Per-plane rest value w_k*density (float32, shape (9,))."""
    return (np.asarray(lattice.WEIGHTS, dtype=np.float64) * float(density)).astype(np.float32)


def plane_inv_scales(density: float) -> np.ndarray:
    """Per-plane dequantize multiplier: float32(1 / float64(s_k)) (shape (9,))."""
    return np.array([np.float32(1.0 / float(s)) for s in plane_scales(density)],
                    dtype=np.float32)


def codec_constants(density: float) -> np.ndarray:
    """(27,) float32: scales, inverse scales, rest values, as the kernels
    take them (lbm::Codec)."""
    return np.ascontiguousarray(np.concatenate(
        [plane_scales(density), plane_inv_scales(density), plane_rest(density)]
    ), dtype=np.float32)


def quantize_plane(f_k: torch.Tensor, k: int, density: float) -> torch.Tensor:
    """float32 plane -> int16 quantized deviations."""
    s = float(plane_scales(density)[k])
    rest = float(plane_rest(density)[k])
    q = torch.round((f_k - rest) * s)
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int16)


def dequantize_plane(q_k: torch.Tensor, k: int, density: float) -> torch.Tensor:
    """int16 quantized deviations -> float32 plane."""
    inv = float(plane_inv_scales(density)[k])
    rest = float(plane_rest(density)[k])
    return q_k.to(torch.float32) * inv + rest


def plane_codec(storage: str, density: float):
    """Per-plane (dequantize, quantize) pair for a storage mode; identity
    codecs for ``f32``."""
    check_storage(storage)
    if storage == "i16":
        return (
            lambda x, k: dequantize_plane(x, k, density),
            lambda x, k: quantize_plane(x, k, density),
        )
    ident = lambda x, k: x  # noqa: E731
    return ident, ident


def quantize(f: torch.Tensor, density: float) -> torch.Tensor:
    """(9, ...) float32 distributions -> int16 state."""
    return torch.stack([quantize_plane(f[k], k, density) for k in range(lattice.NSPEEDS)])


def dequantize(q: torch.Tensor, density: float) -> torch.Tensor:
    """(9, ...) int16 state -> float32 distributions."""
    return torch.stack([dequantize_plane(q[k], k, density) for k in range(lattice.NSPEEDS)])
