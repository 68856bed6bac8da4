"""K9: the HBM-parts K-step sweep (csrc/ca_inplace.cu, ``lbm_hbm_sweep``)
and its wrapper.

Replaces ``lbm_tpu/ops/hbm_pallas.py::_hbm_sweep_kernel`` (:157, entries
``make_sweep`` :272 and ``make_run_all`` :354, the plan ``_plan`` :92 and
``supports`` :133), float32: one sweep advances the whole grid K steps as
``ny / R`` row parts of R rows.  Each part's slab, extended K rows on each
side with periodic wrap, is swept in place by K8's kernel (ops/ca_cuda.py)
in a scratch copy, and its body rows are written to the other state buffer,
so no buffer is read and written in one sweep (as B7 does).  The remainder
steps of a run are K1 steps, as ``hbm_pallas.make_run_all`` does.

The part size (:func:`plan`): on Hopper a part's natural home is the 50 MB
L2, so R is the largest divisor of ny with K <= R, R + 2K <= ny (at most
one image of the driven row in a part's slab) and one f32 copy of the
(R + 2K, nx) extended slab within K3's ``inplace_cuda.L2_INPLACE_BUDGET``
(36 MiB); not the TPU's VMEM plan.  The TPU's ``K % 8 == 0`` rule is not
kept: it exists for 8-aligned DMA row offsets, and the parts here are
windows of the state at any row.  Nor is its three-part minimum, which its
pipeline needed.

The parts are walked in order, one K8 launch each: B7's triple-buffered
pipeline, which overlaps a part's load with the previous part's compute, is
not ported (a TMA/mbarrier pipeline is later work).  Bound: the state's
bytes once per sweep from device memory (plus 2K/R of ghost rows), and per
cell-step 9 x 4 B read + written from L2.

Beside the kernel:

- the plain version, :func:`run_plain`: ``fused_torch.run_sweeps``, K twin
  steps per sweep, which the kernel matches bitwise on fields;
- ``LAUNCHES``: the number of sweeps run (each one K8 launch per part),
  raised only where the kernel is launched.

It runs only when forced (``LBM_TEMPORAL_IMPL=hbm``, models/program.py), as
in ``lbm_tpu``.  A wrapper takes the plain version only for a tensor on the
CPU.  For a CUDA tensor it launches the kernel or raises; it never falls
back.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, ca_cuda, fused_cuda, fused_torch, inplace_cuda, quant
from lbm_tpu_torch.params import LBMParams

LAUNCHES = 0


def plan(params: LBMParams, K: int) -> int | None:
    """Part rows R of a K-deep sweep of this grid (see the module note), or
    None when no part size maps."""
    ny, nx = params.ny, params.nx
    if K < 2:
        return None
    for r in range(ny - 2 * K, K - 1, -1):
        if ny % r == 0 and inplace_cuda.state_bytes(r + 2 * K, nx) <= inplace_cuda.L2_INPLACE_BUDGET:
            return r
    return None


def supports(params: LBMParams, K: int, storage: str = "f32") -> bool:
    """Whether K9 maps a K-deep sweep of this grid: float32 state and a
    part size (:func:`plan`)."""
    quant.check_storage(storage)
    return storage == "f32" and plan(params, K) is not None


def part_obstacles(obstacles: torch.Tensor, R: int, K: int) -> torch.Tensor:
    """(P, R + 2K, nx) uint8: part q's extended obstacle slab, rows
    [qR - K, qR + R + K) mod ny."""
    ny = obstacles.shape[0]
    rows = torch.arange(-K, R + K, device=obstacles.device)
    idx = torch.remainder(torch.arange(0, ny, R, device=obstacles.device)[:, None] + rows, ny)
    return obstacles[idx].to(torch.uint8).contiguous()


def run_plain(f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams, num_steps: int,
              K: int):
    """The plain version of K9: whole sweeps of K twin steps, then single
    steps (``fused_torch.run_sweeps``)."""
    return fused_torch.run_sweeps(f, obstacles, params, num_steps, K)


def make_run_all(params: LBMParams, obstacles: torch.Tensor, num_steps: int, K: int,
                 storage: str = "f32", lib=None):
    """Build ``f0 -> (f_final, tot_us (num_steps,))``: K9 sweeps, then K1
    steps for ``num_steps mod K`` (the signature of
    ``hbm_pallas.make_run_all``).  Both state buffers, the part scratch and
    the per-part obstacle slabs are allocated here, once.  ``f0`` is not
    modified; on the card the returned state is one of the runner's buffers
    and stays valid until its next call.  ``lib`` as in
    ``inplace_cuda.make_run_all``."""
    if not supports(params, K, storage):
        raise ValueError(f"the HBM-parts sweep (K={K}, {storage}) cannot map a "
                         f"{params.ny}x{params.nx} grid")
    n_sweeps, rem = divmod(num_steps, K)
    if obstacles.device.type == "cpu":

        def run_all_plain(f):
            if not fused_cuda.is_plain(f):
                raise ValueError(f"state on {f.device} but obstacle mask on the CPU")
            return run_plain(f, obstacles, params, num_steps, K)

        return run_all_plain

    fused_cuda.check_mask(obstacles, params)
    lib = lib or _build.load()
    dev = obstacles.device
    R = plan(params, K)
    ext = R + 2 * K
    grid = lib.lbm_ca_inplace_grid(ext, params.nx, 0, dev.index)
    if grid <= 0:
        raise RuntimeError(
            f"K9 cannot be launched cooperatively on {torch.cuda.get_device_name(dev)}")
    shape = (9, params.ny, params.nx)
    fa = torch.empty(shape, dtype=torch.float32, device=dev)
    fb = torch.empty_like(fa)
    scratch = torch.empty((9, ext, params.nx), dtype=torch.float32, device=dev)
    gate = torch.empty((2, params.nx), dtype=torch.uint8, device=dev)
    partials = inplace_cuda.partials_buffer(ca_cuda.sweep_plan(ext, params.nx, K, grid), K, dev)
    obst_parts = part_obstacles(obstacles, R, K)
    tail = fused_cuda.make_run_all(params, obstacles, rem) if rem else None
    omega, w1, w2 = fused_torch.step_constants(params)

    def run_all(f):
        global LAUNCHES
        if fused_cuda.is_plain(f):
            raise ValueError("state on the CPU but obstacle mask on a CUDA device")
        fused_cuda.check_state(f, obstacles, params)
        tot = torch.empty(num_steps, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n_sweeps:
            fa.copy_(f)
            for s in range(n_sweeps):
                src, dst = (fa, fb) if s % 2 == 0 else (fb, fa)
                rc = lib.lbm_hbm_sweep(
                    src.data_ptr(), dst.data_ptr(), obst_parts.data_ptr(), scratch.data_ptr(),
                    gate.data_ptr(), partials.data_ptr(), tot.data_ptr() + 4 * s * K,
                    params.ny, params.nx, R, K, params.accel_row, omega, w1, w2, grid, stream,
                    dev.index)
                _build.check(rc, "K9 HBM-parts sweep")
                LAUNCHES += 1
            f = fb if n_sweeps % 2 else fa
        if rem:
            f, tot_rem = tail(f)
            tot[n_sweeps * K:] = tot_rem
        return f, tot

    return run_all
