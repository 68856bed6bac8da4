"""The int16 codec of K1-i16 and K1-slab-i16 (csrc/lbm_common.cuh,
``lbm_decode_word`` / ``lbm_encode_bits``, two of which the kernels pack
into a word with ``__byte_perm(lo, hi, 0x5410)``), run in numpy float32, against
``ops/quant.py``'s ``dequantize_plane`` / ``quantize_plane``: bit for bit.

The kernels decode without an int-to-float conversion (the sign-flipped
int16 ORed under the bits of 12582912.0f, then one exact subtraction) and
encode without a rounding or a float-to-int one (clamp to +-32767, add
12582912.0f, whose unit in the last place is 1, so the sum rounds half to
even, and take the low 16 bits).  ``quant.py`` is tied to ``lbm_tpu``'s
codec by tests/test_torch_quant.py, so these hold the kernels' formulas to
both.  Every int16 value is decoded; every half-integer tie in +-32767.5,
every integer, the floats next to each, values beyond the clamp and +-inf
are encoded.  NaN never reaches a store of a finite run; for it the formula
is held to the kernels' previous encode (rintf, then fmaxf / fminf, which
return the other operand for NaN: -32767), since torch's float-to-int16
conversion of a NaN is not defined (the plain version gives 0 here).
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import quant

DENSITY = 0.1
F32 = np.float32


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _float(u):
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays (selector nibbles 0-7)."""
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, dtype=np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def decode_word(w, inv, rest):
    """lbm_decode_word: (low half, high half) of packed int16 words."""
    u = np.asarray(w, dtype=np.uint32) ^ np.uint32(0x80008000)
    a = _float(byte_perm(u, 0x4B400000, 0x7610)) - F32(12615680.0)
    b = _float(byte_perm(u, 0x4B400000, 0x7632)) - F32(12615680.0)
    return a * F32(inv) + F32(rest), b * F32(inv) + F32(rest)


def encode_bits(v, scale, rest):
    """lbm_encode_bits: the float whose low 16 bits are the int16."""
    with np.errstate(invalid="ignore"):
        r = np.fmin(np.fmax((np.asarray(v, F32) - F32(rest)) * F32(scale), F32(-32767.0)),
                    F32(32767.0))
    return _bits(r + F32(12582912.0))


def encode_word(lo, hi, scale, rest):
    """Two encodes packed as the kernels store them."""
    return byte_perm(encode_bits(lo, scale, rest), encode_bits(hi, scale, rest), 0x5410)


def halves(w):
    w = np.asarray(w, dtype=np.uint32)
    return (w & np.uint32(0xFFFF)).astype(np.uint16).view(np.int16), \
        (w >> np.uint32(16)).astype(np.uint16).view(np.int16)


def pack(lo, hi):
    lo = np.asarray(lo, np.int16).view(np.uint16).astype(np.uint32)
    hi = np.asarray(hi, np.int16).view(np.uint16).astype(np.uint32)
    return lo | (hi << np.uint32(16))


ALL_Q = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)


@pytest.mark.parametrize("k", range(9))
def test_decode_word_equals_dequantize_for_every_int16(k):
    inv, rest = quant.plane_inv_scales(DENSITY)[k], quant.plane_rest(DENSITY)[k]
    want = quant.dequantize_plane(torch.from_numpy(ALL_Q), k, DENSITY).numpy()
    lo, hi = decode_word(pack(ALL_Q, ALL_Q[::-1]), inv, rest)
    np.testing.assert_array_equal(lo.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(hi.view(np.uint32), want[::-1].view(np.uint32))


def _edge_values():
    ints = np.arange(-32768, 32769, dtype=np.float32)
    ties = ints[:-1] + F32(0.5)  # every half-integer tie in [-32767.5, 32767.5]
    base = np.concatenate([ints, ties])
    near = np.concatenate([np.nextafter(base, F32(np.inf)), np.nextafter(base, F32(-np.inf))])
    beyond = np.array([32767.25, 32768.0, 32768.5, 40000.0, 1e9, 3.4e38, -32767.25, -32768.0,
                       -32768.5, -40000.0, -1e9, -3.4e38, np.inf, -np.inf, 0.0, -0.0, 1e-30,
                       -1e-30], dtype=np.float32)
    return np.concatenate([base, near, beyond]).astype(np.float32)


def test_encode_rounds_and_clamps_as_quantize():
    """The rounding core with scale 1 and rest 0: the formula against
    quantize_plane's operations (torch.round, clamp, int16)."""
    r = _edge_values()
    got = halves(encode_word(r, r[::-1], 1.0, 0.0))
    want = torch.clamp(torch.round(torch.from_numpy(r)), -32767.0, 32767.0).to(torch.int16)
    np.testing.assert_array_equal(got[0], want.numpy())
    np.testing.assert_array_equal(got[1], want.numpy()[::-1])


@pytest.mark.parametrize("k", range(9))
def test_encode_word_equals_quantize_plane(k):
    """The 9 planes' own constants over their whole range and beyond
    (a seeded sweep), the values every int16 decodes to, and the midpoints
    between neighbouring decoded values."""
    scale, rest = quant.plane_scales(DENSITY)[k], quant.plane_rest(DENSITY)[k]
    inv = quant.plane_inv_scales(DENSITY)[k]
    span = F32(quant.RANGE_C) * rest
    rng = np.random.default_rng(100 + k)
    sweep = (rest + span * rng.uniform(-1.25, 1.25, 200_000)).astype(np.float32)
    grid = quant.dequantize_plane(torch.from_numpy(ALL_Q), k, DENSITY).numpy()
    mids = ((grid[1:].astype(np.float64) + grid[:-1]) / 2).astype(np.float32)
    f = np.concatenate([sweep, grid, mids, np.array([np.inf, -np.inf], np.float32)])
    want = quant.quantize_plane(torch.from_numpy(f), k, DENSITY).numpy()
    got = halves(encode_word(f, f[::-1], scale, rest))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want[::-1])
    lo, _ = decode_word(pack(want, want), inv, rest)  # decode then encode is the identity
    np.testing.assert_array_equal(halves(encode_word(lo, lo, scale, rest))[0], want)


def test_encode_nan_as_the_previous_kernel_encode():
    def previous(v, scale, rest):  # rintf, then fmaxf / fminf, then the int16 conversion
        with np.errstate(invalid="ignore"):
            r = np.rint((np.asarray(v, F32) - F32(rest)) * F32(scale))
            return np.fmin(np.fmax(r, F32(-32767.0)), F32(32767.0)).astype(np.int16)

    v = np.array([np.nan, -np.nan, 0.01, np.inf], dtype=np.float32)
    for k in range(9):
        scale, rest = quant.plane_scales(DENSITY)[k], quant.plane_rest(DENSITY)[k]
        got = halves(encode_word(v, v, scale, rest))[0]
        np.testing.assert_array_equal(got, previous(v, scale, rest))
        assert got[0] == got[1] == -32767
