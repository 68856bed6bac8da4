"""K10: the two-copy row-block persistent CUDA kernel (csrc/blocked.cu) and its wrappers.

Replaces ``lbm_tpu/ops/resident_pallas.py::_blocked_chunk_kernel`` (:480,
built by ``make_chunk_runner`` :766 -> ``pallas_call`` :882, entry
``make_run_all`` :925).  One cooperative launch runs ``chunk`` steps,
ping-ponging between two device copies of the float32 state with a grid
barrier between steps; each step is walked as tiles of B rows x 256 / B
columns whose windows are the periodic shifted rows of the source, the
driven row read from an accel-adjusted row that the step before wrote
once (see the note at the top of csrc/blocked.cu).

On the TPU this was the ping-pong fallback of a raised scoped-VMEM limit
(``auto_raised_plan`` :165-169), which the in-place band dominated.  Here it
is forced only (``LBM_RESIDENT_KIND=blocked``, models/program.py): both
copies stay in L2 up to 768^2 and stream from HBM beyond.

Bound: 9 x 4 B read + 9 x 4 B written per cell-step, from L2 or HBM, plus
one grid barrier per step and the (ny / B, nx) column partials.

Beside the kernel:

- the plain version, :func:`run_plain` (``fused_torch.blocked_chunk``),
  which the kernel matches bitwise on fields and, through the same
  grouping of the |u| sums, on tot_u;
- ``LAUNCHES``: the number of chunk launches so far, raised only where the
  kernel is launched.

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises; it never falls back.  float32
only, as B4.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_cuda, fused_torch, quant
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0
DEFAULT_CHUNK = 256
# Rows per tile (a divisor of the kernel's 256 threads; the tile is then
# 256 / B columns wide).  Any ny: the last row block is partial where B does
# not divide it.  B fixes the grouping of the |u| sums.  16 from the H100
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md Findings, K10; tools/kernel_times.py
# --blocked, in turns): B = 8 / 16 took 35.9 / 32.5 us/step at 1024^2, the
# grid of K10's main path, and 6.43 / 6.62 at 512^2; B = 4 and 32 were slower.
DEFAULT_BLOCK_ROWS = 16


def check_storage(storage: str) -> None:
    """K10 takes float32 state only, as B4 (``lbm_tpu``'s text,
    resident_pallas.py:794-798)."""
    quant.check_storage(storage)
    if storage != "f32":
        raise ValueError(
            f"storage {storage!r} maps only the in-place resident kernel (pass inplace=True)")


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              block_rows: int = DEFAULT_BLOCK_ROWS):
    """The plain version of K10: ``num_steps`` steps of
    ``fused_torch.blocked_chunk``, per-step tot_u."""
    return fused_torch.blocked_chunk(f, obstacles, params, num_steps, block_rows)


def make_run_all(
    params: LBMParams,
    obstacles: torch.Tensor,
    num_steps: int,
    chunk: int = DEFAULT_CHUNK,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    storage: str = "f32",
):
    """Build ``f0 -> (f_final, tot_us (num_steps,))`` as full chunks, then a
    remainder chunk, each one K10 launch (the signature of
    ``lbm_tpu.ops.resident_pallas.make_run_all(..., force_blocked=True)``).

    Both state copies, the driven-row scratch, the partials and the column
    sums are allocated here, once.  ``f0`` is not modified.  On the card the
    returned state is one of the runner's copies and stays valid until the
    runner's next call."""
    check_storage(storage)
    if block_rows < 1 or 256 % block_rows:
        raise ValueError(f"block_rows must divide 256, got {block_rows}")
    chunk = max(1, min(chunk, num_steps)) if num_steps else 1
    n_full, rem = divmod(num_steps, chunk)
    chunks = [chunk] * n_full + ([rem] if rem else [])

    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not fused_cuda.is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            parts = []
            for n in chunks:
                f, tot = run_plain(f, obstacles, params, n, block_rows)
                parts.append(tot)
            return f, (torch.cat(parts) if parts else torch.empty(0, dtype=torch.float32))

        return run_all_plain

    fused_cuda.check_mask(obstacles, params)
    lib = _build.load()
    dev = obstacles.device
    grid = lib.lbm_blocked_grid(params.ny, params.nx, block_rows, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K10 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}"
        )
    shape = (9, params.ny, params.nx)
    fa = torch.empty(shape, dtype=torch.float32, device=dev)
    fb = torch.empty(shape, dtype=torch.float32, device=dev)
    adj = torch.zeros((2, 9, params.nx), dtype=torch.float32, device=dev)
    nby = -(-params.ny // block_rows)
    part = torch.empty((2, nby, params.nx), dtype=torch.float32, device=dev)
    colsum = torch.empty((chunk, params.nx), dtype=torch.float32, device=dev)
    omega, w1, w2 = fused_torch.step_constants(params)

    def run_all(f):
        global LAUNCHES
        if fused_cuda.is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        fused_cuda.check_state(f, obstacles, params)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        if f.data_ptr() != fa.data_ptr():
            fa.copy_(f)
        src, dst, done = fa, fb, 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n in chunks:
            rc = lib.lbm_blocked_chunk(
                src.data_ptr(), dst.data_ptr(), obstacles.data_ptr(), adj.data_ptr(),
                part.data_ptr(), colsum.data_ptr(), tot.data_ptr() + 4 * done, params.ny,
                params.nx, params.accel_row, omega, w1, w2, n, block_rows, grid, stream,
                dev.index,
            )
            _build.check(rc, "K10 blocked kernel")
            LAUNCHES += 1
            if n % 2:
                src, dst = dst, src
            done += n
        return src, tot

    return run_all
