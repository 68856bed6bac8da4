"""The fused collide-stream timestep in plain PyTorch: the twin of the step.

The torch counterpart of ``lbm_tpu/ops/fused_jnp.py`` (full-grid form):
driven-row injection, pull streaming with periodic wrap on both axes,
bounce-back, BGK collision and the per-step |u| sum, with the cell math of
ops/stencil_math.py.  It runs on any device and is the plain version every
CUDA kernel of this package is held to, bitwise on fields.

``fused_step_i16`` is the same step on int16 storage (ops/quant.py):
dequantize, step in float32, quantize.  That is B1's i16 order, load ->
dequant -> accel -> stream -> collide -> quant
(``lbm_tpu/ops/fused_pallas.py:304-351``), and the plain version of every
i16 kernel here.

``sweep`` / ``run_sweeps`` are K steps taken as one temporal sweep, the
plain version of the sweep kernels (K4, K5): bitwise K twin steps in f32,
and one quantization per sweep in int16.

The slab form (``stream_slab`` / ``fused_step_slab``, and
``fused_step_slab_i16`` on int16 storage) is the per-shard step of the
sharded modes (parallel/modes.py): one step over a row slab with one ghost
row on each side, the plain version of K1-slab.

``blocked_chunk`` is the plain version of K10: a chunk of steps walked as
row blocks over two copies, with its per-step |u| grouping
(``column_sum``).

``ca_sweep`` is the plain version of the ca engines (K4-slab, K7, K8): K
periodic steps of a shard's ghost-extended slab (``fused_step_ext``),
returning the body rows and the per-level |u| of the body; int16 is
quantized once per sweep (K4-slab-i16) or once per step (K8-i16).

``ensemble_step`` / ``run_ensemble_plain`` are the twin step over a
leading instance dimension with omega and the accel weights per instance
(``lbm_tpu``'s ``_step_traced`` under ``jax.vmap``,
``lbm_tpu/tools/ensemble.py:47``, :117): the plain version of the batched
kernels K1-batch and K2-batch (ops/ensemble_cuda.py), and the ensemble's
CPU path.  Instance b is bitwise a :func:`run_steps` run with b's omega
and accel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbm_tpu_torch.core import lattice
from lbm_tpu_torch.ops import quant, stencil_math
from lbm_tpu_torch.params import LBMParams


class StepOutput(NamedTuple):
    f: torch.Tensor  # (9, ny, nx) post-collision distributions
    tot_u: torch.Tensor  # scalar: sum over fluid cells of |u| (pre-division)


def step_constants(params: LBMParams) -> tuple[float, float, float]:
    """(omega, w1, w2) as float32 values, the constants every step takes."""
    w1, w2 = lattice.accel_weights(params.density, params.accel)
    return float(np.float32(params.omega)), float(w1), float(w2)


def apply_accel_row(row: torch.Tensor, fluid_row: torch.Tensor, w1: float, w2: float):
    """Driven-row injection on a (9, nx) row (SerialCode/d2q9-bgk.c:216-246).

    Guard: fluid cell AND all three decremented west-side speeds stay
    strictly positive.  Returns a new (9, nx) row.
    """
    planes = stencil_math.accel_planes(list(row), fluid_row, True, w1, w2)
    return torch.stack(planes)


def stream_periodic(f: torch.Tensor) -> torch.Tensor:
    """Full-grid pull streaming with periodic wrap on both axes
    (SerialCode/d2q9-bgk.c:248-277): ``tmp[k][j,i] = f[k][j-cy, i-cx]``."""
    return torch.stack(
        [
            torch.roll(f[k], shifts=(lattice.CY[k], lattice.CX[k]), dims=(0, 1))
            for k in range(lattice.NSPEEDS)
        ]
    )


def stream_slab(slab: torch.Tensor) -> torch.Tensor:
    """Pull streaming over a ghosted row slab (``lbm_tpu``'s
    ``fused_jnp.stream_slab``): ``slab`` is (9, n+2, nx), rows 0 and n+1
    the ghost rows; x wraps, y reads come from the slab.  Returns (9, n, nx)."""
    n = slab.shape[1] - 2
    return torch.stack([
        torch.roll(slab[k, 1 - lattice.CY[k]: 1 - lattice.CY[k] + n, :], lattice.CX[k], dims=1)
        for k in range(lattice.NSPEEDS)
    ])


def fused_step_slab(
    slab: torch.Tensor, obstacles_slab: torch.Tensor, params: LBMParams, row_offset: int
) -> StepOutput:
    """One step over a ghosted row slab, the sharded building block
    (``lbm_tpu``'s ``fused_jnp.fused_step_slab``).

    ``slab`` (9, n+2, nx) float32 pre-injection, ghosts included;
    ``obstacles_slab`` (n+2, nx) bool; ``row_offset`` the global row of slab
    row 1.  The driven-row injection applies to every slab row whose global
    index ``row_offset - 1 + j`` is ``accel_row``, ghosts included, as the
    shard owning that row computes it.  Returns ((9, n, nx), tot_u)."""
    omega, w1, w2 = step_constants(params)
    n = slab.shape[1] - 2
    rows = row_offset - 1 + torch.arange(n + 2, device=slab.device)
    driven = (rows == params.accel_row)[:, None]
    planes = stencil_math.accel_planes(list(slab), ~obstacles_slab, driven, w1, w2)
    streamed = stream_slab(torch.stack(planes))
    out_planes, tot_u = stencil_math.collide_and_av(list(streamed), obstacles_slab[1:1 + n],
                                                     omega)
    return StepOutput(torch.stack(out_planes), tot_u)


def fused_step_slab_i16(
    slab: torch.Tensor, obstacles_slab: torch.Tensor, params: LBMParams, row_offset: int
) -> StepOutput:
    """:func:`fused_step_slab` on int16 storage: decode the slab (ghosts,
    exchanged as int16, too), step, encode, as :func:`fused_step_i16`."""
    f_new, tot_u = fused_step_slab(quant.dequantize(slab, params.density), obstacles_slab,
                                   params, row_offset)
    return StepOutput(quant.quantize(f_new, params.density), tot_u)


def fused_step_single(
    f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams
) -> StepOutput:
    """One full timestep on one device (periodic full grid).

    ``f`` (9, ny, nx) float32 and ``obstacles`` (ny, nx) bool on the same
    device.  ``f`` is not modified.
    """
    omega, w1, w2 = step_constants(params)
    jj = params.accel_row
    f = f.clone()
    f[:, jj, :] = apply_accel_row(f[:, jj, :], ~obstacles[jj, :], w1, w2)
    streamed = stream_periodic(f)
    out_planes, tot_u = stencil_math.collide_and_av(list(streamed), obstacles, omega)
    return StepOutput(torch.stack(out_planes), tot_u)


def fused_step_i16(
    q: torch.Tensor, obstacles: torch.Tensor, params: LBMParams
) -> StepOutput:
    """One step on int16 state: ``q`` (9, ny, nx) int16 -> (int16 state,
    tot_u), tot_u taken from the dequantized values."""
    f_new, tot_u = fused_step_single(quant.dequantize(q, params.density), obstacles, params)
    return StepOutput(quant.quantize(f_new, params.density), tot_u)


def run_steps(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    num_steps: int,
    storage: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` twin steps: returns (f_final, tot_us (num_steps,)).
    With ``storage="i16"`` the state is int16 in and out.

    The per-step sums are written into one tensor on ``f``'s device, so the
    loop never waits for the device."""
    quant.check_storage(storage)
    step = fused_step_i16 if storage == "i16" else fused_step_single
    tot_us = torch.empty(num_steps, dtype=torch.float32, device=f.device)
    for t in range(num_steps):
        f, tot_us[t] = step(f, obstacles, params)
    return f, tot_us


def sweep(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    K: int,
    storage: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One K-step temporal sweep, the plain version of the sweep kernels
    (K4, K5): decode the state once, take K float32 twin steps, encode once;
    returns (state, tot_us (K,)), tot_u taken from the float32 levels.

    For int16 storage that is what ``lbm_tpu``'s sweeps compute: the levels
    stay float32 on chip and the state is quantized once per sweep, with the
    per-plane codec of ``quant.plane_codec``
    (``lbm_tpu/ops/temporal_pallas.py:205``, ``skew_pallas.py:249``).  For
    float32 it is K twin steps."""
    deq, enq = quant.plane_codec(storage, params.density)
    x = torch.stack([deq(f[k], k) for k in range(lattice.NSPEEDS)])
    x, tot_us = run_steps(x, obstacles, params, K)
    return torch.stack([enq(x[k], k) for k in range(lattice.NSPEEDS)]), tot_us


def run_sweeps(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    num_steps: int,
    K: int,
    storage: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` steps as whole K-step sweeps, then the remainder as
    single steps (``temporal_pallas.make_run_all`` :673): returns (state,
    tot_us (num_steps,))."""
    n_sweeps, rem = divmod(num_steps, K)
    parts = []
    for _ in range(n_sweeps):
        f, tot = sweep(f, obstacles, params, K, storage)
        parts.append(tot)
    f, tot = run_steps(f, obstacles, params, rem, storage)
    parts.append(tot)
    return f, torch.cat(parts)


REDUCE_THREADS = 256  # threads of csrc/lbm_common.cuh lbm_reduce_row


def column_sum(vec: torch.Tensor) -> torch.Tensor:
    """The sum of an (nx,) or (1, nx) float32 vector in the fixed order of
    ``lbm_reduce_row`` (csrc/lbm_common.cuh), so that the plain version of a
    kernel that ends in it gives the kernel's bits: thread t of 256 adds
    entries t, t + 256, ... in turn, then a tree halves the 256 sums."""
    v = vec.reshape(-1)
    n = REDUCE_THREADS
    v = torch.cat([v, v.new_zeros((-v.numel()) % n)])
    acc = v[:n]
    for r in range(1, v.numel() // n):
        acc = acc + v[r * n:(r + 1) * n]
    while n > 1:
        n //= 2
        acc = acc[:n] + acc[n:2 * n]
    return acc[0]


def blocked_chunk(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, chunk: int,
                  block_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K10 (csrc/blocked.cu), which computes what
    ``lbm_tpu``'s ``_blocked_chunk_kernel`` (resident_pallas.py:480)
    computes: ``chunk`` steps ping-ponging between two copies of the
    (9, ny, nx) float32 state; each step takes the driven row's
    accel-adjusted row once from the pre-stream source (:499-505), then walks
    row blocks of ``block_rows`` rows (the last one partial where they do not
    divide ny), each block reading the periodic shifted windows
    ``[r0 - cy, r0 + B - cy)`` of the adjusted source (:507-537) and
    colliding through ``stencil_math.collide_and_av_rows``; the block
    partials are summed in block order, then once over the columns
    (:539-555, :func:`column_sum`).  An odd chunk ends in the second copy,
    an even one in the first (:557-570).

    Fields equal the twin step's bitwise; tot_u (chunk,) is K10's grouping.
    ``f`` is not modified."""
    omega, w1, w2 = step_constants(params)
    ny, nx, ar = params.ny, params.nx, params.accel_row
    B = block_rows
    copies = [f.clone(), torch.empty_like(f)]
    tot_us = torch.empty(chunk, dtype=torch.float32, device=f.device)
    for t in range(chunk):
        src, dst = copies[t % 2], copies[(t + 1) % 2]
        adj = apply_accel_row(src[:, ar, :], ~obstacles[ar, :], w1, w2)
        src = src.clone()
        src[:, ar, :] = adj
        tot = None
        for r0 in range(0, ny, B):
            r1 = min(r0 + B, ny)
            streamed = [
                torch.roll(src[k, torch.remainder(torch.arange(r0, r1, device=f.device)
                                                  - lattice.CY[k], ny)],
                           lattice.CX[k], dims=1)
                for k in range(lattice.NSPEEDS)
            ]
            out, partial = stencil_math.collide_and_av_rows(streamed, obstacles[r0:r1], omega)
            dst[:, r0:r1] = torch.stack(out)
            tot = partial if tot is None else tot + partial
        tot_us[t] = column_sum(tot)
    return copies[chunk % 2], tot_us


def fused_step_ext(f_ext: torch.Tensor, obst_ext: torch.Tensor, params: LBMParams,
                   base_row: int, ny_global: int, body: tuple[int, int]) -> StepOutput:
    """One periodic step of a ghost-extended slab (``lbm_tpu``'s
    ``_ca_ext_kernel`` step): ``f_ext`` (9, ext, nx) float32, ``obst_ext``
    (ext, nx) bool, extended row e at global row ``(base_row + e) mod
    ny_global`` (the driven row is injected wherever it falls), streaming
    wrapped inside the slab on both axes, so the rows next to the slab's
    edges turn to garbage one row per step while the rows K steps from them
    stay exact.  tot_u sums the fluid cells of rows ``body`` = [a, b) only."""
    omega, w1, w2 = step_constants(params)
    rows = torch.remainder(base_row + torch.arange(f_ext.shape[1], device=f_ext.device),
                           ny_global)
    driven = (rows == params.accel_row)[:, None]
    planes = stencil_math.accel_planes(list(f_ext), ~obst_ext, driven, w1, w2)
    streamed = list(stream_periodic(torch.stack(planes)))
    rho, u_x, u_y = stencil_math.moments(streamed)
    u_sq = u_x * u_x + u_y * u_y
    out = stencil_math.collide(streamed, obst_ext, omega, rho, u_x, u_y, u_sq)
    a, b = body
    tot_u = torch.sum(stencil_math.speeds(u_sq[a:b], ~obst_ext[a:b]), dtype=torch.float32)
    return StepOutput(torch.stack(out), tot_u)


def ca_sweep(lo: torch.Tensor, body: torch.Tensor, hi: torch.Tensor, obst_ext: torch.Tensor,
             params: LBMParams, row_offset: int, ny_global: int, storage: str = "f32",
             quantize: str = "sweep") -> tuple[torch.Tensor, torch.Tensor]:
    """The plain ca sweep: K = ``lo.shape[1]`` steps of the n body rows of
    one shard from its ghost-extended slab ``[lo | body | hi]`` (K rows
    each side; ``obst_ext`` (n + 2K, nx) bool; ``row_offset`` the global row
    of body row 0): K :func:`fused_step_ext` steps, returning (body',
    tot_us (K,)), the body K synchronous steps later and its per-level
    |u| sums (``lbm_tpu``'s ``make_slab_sweep`` / ``make_ca_chunk_runner``
    / ``make_ca_inplace_runner``).

    int16 state: ``quantize="sweep"`` decodes once and encodes once (B5's
    slab sweep, K4-slab-i16), ``"step"`` encodes and decodes every step
    (B10, K8-i16)."""
    quant.check_storage(storage)
    if quantize not in ("sweep", "step"):
        raise ValueError(f"quantize must be 'sweep' or 'step', got {quantize!r}")
    deq, enq = quant.plane_codec(storage, params.density)

    def decode(x):
        return torch.stack([deq(x[k], k) for k in range(lattice.NSPEEDS)])

    def encode(x):
        return torch.stack([enq(x[k], k) for k in range(lattice.NSPEEDS)])

    K, n = lo.shape[1], body.shape[1]
    x = decode(torch.cat([lo, body, hi], dim=1))
    tot_us = torch.empty(K, dtype=torch.float32, device=body.device)
    for t in range(K):
        x, tot_us[t] = fused_step_ext(x, obst_ext, params, row_offset - K, ny_global, (K, K + n))
        if quantize == "step" and t + 1 < K:
            x = decode(encode(x))
    return encode(x[:, K:K + n]), tot_us


def ensemble_weights(density: float, accels) -> tuple[np.ndarray, np.ndarray]:
    """Per-instance accel weights (w1s, w2s), float32 arrays, computed as
    ``lbm_tpu``'s ensemble does (``lbm_tpu/tools/ensemble.py:110-111``):
    the same float32 operations as ``lattice.accel_weights``, vectorized."""
    accels = np.asarray(accels, dtype=np.float32)
    return (np.float32(density) * accels / np.float32(9.0),
            np.float32(density) * accels / np.float32(36.0))


def ensemble_step(f_b: torch.Tensor, obstacles: torch.Tensor, omegas: torch.Tensor,
                  w1s: torch.Tensor, w2s: torch.Tensor, accel_row: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One twin step of B instances: ``f_b`` (B, 9, ny, nx) float32,
    ``obstacles`` (ny, nx) bool shared by every instance or (B, ny, nx) for
    a geometry sweep, ``omegas``, ``w1s``, ``w2s`` (B,) float32 tensors on
    ``f_b``'s device.  Returns (f_b', tot_u (B,)).

    :func:`fused_step_single` op for op with the scalars broadcast as
    (B, 1, 1) (or (B, 1) on the driven row) and the rolls over the last two
    axes; each instance's tot_u is summed over its own contiguous (ny, nx)
    plane, as the single step sums it, so instance b is bitwise a single
    run.  ``f_b`` is not modified."""
    B = f_b.shape[0]
    om = omegas.reshape(B, 1, 1)
    fluid = ~obstacles
    jj = accel_row
    f = f_b.clone()
    planes = stencil_math.accel_planes([f[:, k, jj, :] for k in range(lattice.NSPEEDS)],
                                       fluid[..., jj, :], True, w1s.reshape(B, 1),
                                       w2s.reshape(B, 1))
    f[:, :, jj, :] = torch.stack(planes, dim=1)
    streamed = [torch.roll(f[:, k], shifts=(lattice.CY[k], lattice.CX[k]), dims=(1, 2))
                for k in range(lattice.NSPEEDS)]
    rho, u_x, u_y = stencil_math.moments(streamed)
    u_sq = u_x * u_x + u_y * u_y
    out = stencil_math.collide(streamed, obstacles, om, rho, u_x, u_y, u_sq)
    speed = stencil_math.speeds(u_sq, fluid.expand(B, -1, -1))
    tot = torch.stack([torch.sum(speed[b], dtype=torch.float32) for b in range(B)])
    return torch.stack(out, dim=1), tot


def run_ensemble_plain(f_b: torch.Tensor, obstacles: torch.Tensor, omegas: torch.Tensor,
                       w1s: torch.Tensor, w2s: torch.Tensor, accel_row: int,
                       num_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` :func:`ensemble_step` steps: (f_b, tot (num_steps, B)),
    the per-step sums written into one tensor on ``f_b``'s device."""
    tot = torch.empty((num_steps, f_b.shape[0]), dtype=torch.float32, device=f_b.device)
    for t in range(num_steps):
        f_b, tot[t] = ensemble_step(f_b, obstacles, omegas, w1s, w2s, accel_row)
    return f_b, tot
