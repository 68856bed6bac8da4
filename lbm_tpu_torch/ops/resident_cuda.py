"""K2: the persistent multi-step CUDA kernel (csrc/resident.cu) and its wrappers.

Replaces ``lbm_tpu/ops/resident_pallas.py::_chunk_kernel`` (:213, entries
``make_chunk_runner`` :766 and ``make_run_all`` :925), f32 path.  One
cooperative launch runs ``chunk`` steps, ping-ponging between two device
buffers with a grid barrier between steps, so the state stays in the
card's 50 MB L2 for the whole chunk.

Bound: the same 9 x 4 B read + 9 x 4 B written per cell-step as K1, from L2
instead of device memory while both copies fit, plus one grid barrier per
step.  The program picks it only where ``2 x 9 x ny x nx x 4`` bytes fit
:data:`L2_STATE_BUDGET` (see the note at the top of csrc/resident.cu).

Beside the kernel:

- the plain version, :func:`run_plain`: a loop of the twin step
  (ops/fused_torch.py) returning per-step tot_u, which the kernel matches
  bitwise on fields;
- ``LAUNCHES``: the number of chunk launches so far, raised only where the
  kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0
DEFAULT_CHUNK = 256

# Two f32 copies of the state must fit this share of the H100's 50 MB L2
# for the multi-step kernel to be chosen.  A first guess, to be set by the
# K1/K2 measurements across grids in PERF.md.
L2_STATE_BUDGET = 24 * 2**20


def fits_l2(ny: int, nx: int) -> bool:
    """Whether the two ping-pong copies of a (9, ny, nx) f32 state fit
    :data:`L2_STATE_BUDGET`."""
    return 2 * 9 * ny * nx * 4 <= L2_STATE_BUDGET


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int):
    """The plain version of K2: ``num_steps`` twin steps, per-step tot_u."""
    return fused_torch.run_steps(f, obstacles, params, num_steps)


def make_run_all(
    params: LBMParams, obstacles: torch.Tensor, num_steps: int, chunk: int = DEFAULT_CHUNK
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` as full chunks, then a
    remainder chunk, each one K2 launch (the signature of
    ``lbm_tpu.ops.resident_pallas.make_run_all``).

    Both state buffers and the (chunk, blocks) partials are allocated here,
    once.  ``f0`` is not modified.  On the card the returned state is one of
    the runner's buffers and stays valid until the runner's next call."""
    chunk = max(1, min(chunk, num_steps)) if num_steps else 1
    n_full, rem = divmod(num_steps, chunk)
    chunks = [chunk] * n_full + ([rem] if rem else [])

    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not fused_cuda.is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return run_plain(f, obstacles, params, num_steps)

        return run_all_plain

    fused_cuda.check_mask(obstacles, params)
    lib = _build.load()
    dev = obstacles.device
    grid = lib.lbm_resident_grid(params.ny, params.nx, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K2 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}"
        )
    shape = (9, params.ny, params.nx)
    fa = torch.empty(shape, dtype=torch.float32, device=dev)
    fb = torch.empty(shape, dtype=torch.float32, device=dev)
    partials = torch.empty((chunk, grid), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)

    def run_all(f):
        global LAUNCHES
        if fused_cuda.is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        fused_cuda.check_state(f, obstacles, params)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        fa.copy_(f)
        src, dst, done = fa, fb, 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n in chunks:
            rc = lib.lbm_resident_chunk(
                src.data_ptr(), dst.data_ptr(), obstacles.data_ptr(), partials.data_ptr(),
                tot.data_ptr() + 4 * done, params.ny, params.nx, params.accel_row,
                omega, w1, w2, n, grid, stream, dev.index,
            )
            _build.check(rc, "K2 resident kernel")
            LAUNCHES += 1
            if n % 2:
                src, dst = dst, src
            done += n
        return src, tot

    return run_all
