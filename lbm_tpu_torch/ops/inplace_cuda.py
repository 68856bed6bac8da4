"""K3: the in-place persistent multi-step CUDA kernel (csrc/inplace.cu) and its wrappers.

Replaces ``lbm_tpu/ops/resident_pallas.py::_inplace_blocked_kernel`` (:601,
entries ``make_chunk_runner`` :766 and ``make_run_all`` :925 with
``inplace=True``), float32 state (K3) and int16 state (K3-i16,
``storage="i16"``, ops/quant.py).  One cooperative launch runs ``chunk``
steps on ONE device copy of the state, updated in place, so a state whose
two copies do not fit the card's 50 MB L2 (1024^2 f32: 72 MiB) can still
stay there (36 MiB).

Bound: 9 reads + 9 writes of state per cell-step from L2 while the copy
stays there, plus one grid barrier per step.  Steps alternate between two
layouts of the buffer (the AA pattern) so that every cell reads and writes
only its own slots and all cells run in parallel; a byte per driven-row
column carries the injection guard (see the note at the top of
csrc/inplace.cu).  Between the launches of one run the buffer holds a
kernel layout; a run ends in the canonical (9, ny, nx) layout, in the
state buffer for an even step count and in a second buffer for an odd one.

Beside the kernel:

- the plain version, :func:`run_plain`: a loop of the twin step
  (ops/fused_torch.py; the int16 step for ``storage="i16"``), which the
  kernel matches bitwise on fields;
- ``LAUNCHES`` (f32) and ``LAUNCHES_I16`` (int16): the number of chunk
  launches so far, raised only where the kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch, quant
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0
LAUNCHES_I16 = 0
DEFAULT_CHUNK = 256

# One copy of the state must fit this many bytes for the program to pick K3
# (where K2 has not been picked), per storage.  f32: the 1024^2 headline
# (36 MiB); on the card K3 was faster there than K2 and K1 (29.0 us/step
# against 30.1 and 31.5).  int16: to 256^2 (1.1 MiB), where K3-i16 beat
# K1-i16 in turns (256^2: 3.32 against 3.79; 128^2: 2.63 against 3.45);
# K1-i16 won in turns at 512^2 (7.15 against 7.83), 768^2 (12.97 against
# 17.18) and 1024^2 (25.64 against 26.97; PERF.md §5).
L2_INPLACE_BUDGET = 36 * 2**20
L2_INPLACE_BUDGET_I16 = 2 * 2**20


def state_bytes(ny: int, nx: int, storage: str = "f32") -> int:
    return 9 * ny * nx * (2 if storage == "i16" else 4)


def fits_l2(ny: int, nx: int, storage: str = "f32") -> bool:
    """Whether one copy of a (9, ny, nx) state fits the budget of its
    storage: :data:`L2_INPLACE_BUDGET` (f32) or
    :data:`L2_INPLACE_BUDGET_I16` (int16)."""
    budget = L2_INPLACE_BUDGET_I16 if storage == "i16" else L2_INPLACE_BUDGET
    return state_bytes(ny, nx, storage) <= budget


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              storage: str = "f32"):
    """The plain version of K3: ``num_steps`` twin steps, per-step tot_u."""
    return fused_torch.run_steps(f, obstacles, params, num_steps, storage)


def make_run_all(
    params: LBMParams,
    obstacles: torch.Tensor,
    num_steps: int,
    chunk: int = DEFAULT_CHUNK,
    storage: str = "f32",
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` as full chunks, then a
    remainder chunk, each one K3 launch (the signature of
    ``lbm_tpu.ops.resident_pallas.make_run_all(..., inplace=True)``).

    The state buffer (and, for an odd ``num_steps``, the second buffer the
    last step writes), the guard bytes and the (chunk, blocks) partials are
    allocated here, once.  ``f0`` is not modified: it is copied into the
    state buffer, unless it is that buffer (the previous call's result, as
    the driver passes segment to segment).  On the card the returned state
    is one of the runner's buffers and stays valid until its next call."""
    quant.check_storage(storage)
    chunk = max(1, min(chunk, num_steps)) if num_steps else 1
    n_full, rem = divmod(num_steps, chunk)
    chunks = [chunk] * n_full + ([rem] if rem else [])

    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not fused_cuda.is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return run_plain(f, obstacles, params, num_steps, storage)

        return run_all_plain

    fused_cuda.check_mask(obstacles, params)
    lib = _build.load()
    dev = obstacles.device
    i16, codec = fused_cuda.codec_arg(params, storage)
    grid = lib.lbm_inplace_grid(params.ny, params.nx, i16, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K3 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}"
        )
    shape = (9, params.ny, params.nx)
    dtype = fused_cuda.STATE_DTYPES[storage]
    state = torch.empty(shape, dtype=dtype, device=dev)
    spare = torch.empty(shape, dtype=dtype, device=dev) if num_steps % 2 else state
    gate = torch.empty((2, params.nx), dtype=torch.uint8, device=dev)
    partials = torch.empty((chunk, grid), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)

    def run_all(f):
        global LAUNCHES, LAUNCHES_I16
        if fused_cuda.is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        fused_cuda.check_state(f, obstacles, params, storage)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        if num_steps == 0:
            return f, tot
        if f.data_ptr() != state.data_ptr():
            state.copy_(f)
        done = 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n in chunks:
            rc = lib.lbm_inplace_chunk(
                state.data_ptr(), spare.data_ptr(), obstacles.data_ptr(), gate.data_ptr(),
                partials.data_ptr(), tot.data_ptr() + 4 * done, params.ny, params.nx,
                params.accel_row, omega, w1, w2, i16, fused_cuda.codec_ptr(codec), done, n,
                int(done == 0), int(done + n == num_steps), grid, stream, dev.index,
            )
            _build.check(rc, "K3 in-place kernel")
            if i16:
                LAUNCHES_I16 += 1
            else:
                LAUNCHES += 1
            done += n
        return spare, tot

    return run_all
