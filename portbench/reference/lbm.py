"""The plain D2Q9-BGK reference: the upstream serial solver in plain PyTorch.

One timestep is the upstream's ``timestep`` (Xinran1205/LBM-Asynchronous,
``SerialCode/d2q9-bgk.c``): ``accelerate_flow`` on the second row from the
top, ``propagate`` (pull streaming, periodic on both axes), ``rebound``
(bounce-back on wall cells) and ``collision`` (BGK relaxation toward the
second-order equilibrium, written in the C source's form
``w rho (1 + u/c^2 + u^2/(2c^4) - |u|^2/(2c^2))``), then ``av_velocity``:
the mean |u| over the fluid cells of the post-collision state.

It steps B instances at once, each with its own omega and accel, on one
shared wall mask or one mask an instance, in the dtype it is given
(float32, or a lower precision for the control).  It imports nothing of the
program under test and takes nothing the program has made: the rest state,
the weights and the driven-row increments are worked out here.
"""

from __future__ import annotations

import torch

CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
WEIGHTS = (4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36)


class Lattice:
    """The constants and masks of B instances on one device, in ``dtype``."""

    def __init__(self, wall: torch.Tensor, omegas, accels, density: float,
                 dtype: torch.dtype = torch.float32):
        dev = wall.device
        B = len(omegas)
        self.dtype = dtype
        self.wall = (wall if wall.dim() == 3 else wall.unsqueeze(0)).unsqueeze(1)  # (B|1,1,ny,nx)
        self.fluid = ~self.wall[:, 0]  # (B|1, ny, nx)
        self.n_fluid = self.fluid.sum((-2, -1)).to(torch.float64).expand(B)
        as_t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)  # noqa: E731
        self.w = as_t(WEIGHTS).to(dtype).view(1, 9, 1, 1)
        self.cx = as_t(CX).to(dtype).view(1, 9, 1, 1)
        self.cy = as_t(CY).to(dtype).view(1, 9, 1, 1)
        self.omega = as_t(omegas).to(dtype).view(B, 1, 1, 1)
        accels = as_t(accels)
        self.w1 = (density * accels / 9.0).to(dtype).view(B, 1)
        self.w2 = (density * accels / 36.0).to(dtype).view(B, 1)
        self.zero = torch.zeros((), dtype=dtype, device=dev)
        self.opp = torch.tensor(OPP, device=dev)
        self.density = density
        self.B = B

    def rest(self, ny: int, nx: int) -> torch.Tensor:
        """The rest equilibrium, density * w_k in every cell: (B, 9, ny, nx)."""
        f = (self.w * self.density).to(self.dtype)
        return f.expand(self.B, 9, ny, nx).contiguous()


def velocity(f: torch.Tensor):
    """Per-cell density and velocity of (B, 9, ny, nx) distributions."""
    rho = f.sum(1)
    ux = (f[:, 1] + f[:, 5] + f[:, 8] - (f[:, 3] + f[:, 6] + f[:, 7])) / rho
    uy = (f[:, 2] + f[:, 5] + f[:, 6] - (f[:, 4] + f[:, 7] + f[:, 8])) / rho
    return rho, ux, uy


def step(f: torch.Tensor, lat: Lattice) -> tuple[torch.Tensor, torch.Tensor]:
    """One timestep of every instance: (f', tot_u (B,)), tot_u the sum of
    |u| over the fluid cells of f'.  ``f`` is updated in place by the
    driven-row injection and must not be used afterwards."""
    jj = f.shape[2] - 2
    row = f[:, :, jj, :]
    ok = (lat.fluid[:, jj, :] & (row[:, 3] - lat.w1 > 0) & (row[:, 6] - lat.w2 > 0)
          & (row[:, 7] - lat.w2 > 0))
    zero = lat.zero
    d1, d2 = torch.where(ok, lat.w1, zero), torch.where(ok, lat.w2, zero)
    row[:, 1] += d1
    row[:, 5] += d2
    row[:, 8] += d2
    row[:, 3] -= d1
    row[:, 6] -= d2
    row[:, 7] -= d2

    tmp = torch.empty_like(f)
    for k in range(9):
        tmp[:, k] = torch.roll(f[:, k], shifts=(CY[k], CX[k]), dims=(1, 2))

    rho, ux, uy = velocity(tmp)
    usq = (ux * ux + uy * uy).unsqueeze(1)
    cu = lat.cx * ux.unsqueeze(1) + lat.cy * uy.unsqueeze(1)
    feq = lat.w * rho.unsqueeze(1) * (1.0 + 3.0 * cu + 4.5 * (cu * cu) - 1.5 * usq)
    out = torch.where(lat.wall, tmp.index_select(1, lat.opp), tmp + lat.omega * (feq - tmp))

    _, ux, uy = velocity(out)
    speed = torch.where(lat.fluid, torch.sqrt(ux * ux + uy * uy), zero)
    return out, speed.sum((1, 2))


def run(wall: torch.Tensor, omegas, accels, density: float, steps: int,
        dtype: torch.dtype = torch.float32, store: torch.dtype | None = None,
        graph_steps: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``steps`` timesteps of B instances from rest, on ``wall``'s device:
    (f (B, 9, ny, nx) in ``dtype``, av_vels (steps, B) float64), av_vels
    the per-step tot_u over each instance's fluid-cell count.  ``store``
    rounds the state to that dtype after every step (a lower-precision
    state with ``dtype`` arithmetic).

    On a CUDA device the steps run ``graph_steps`` at a time from a
    captured CUDA graph of plain PyTorch operations (the same kernels on the
    same buffers as the eager loop, without a host launch per operation)."""
    lat = Lattice(wall, omegas, accels, density, dtype)
    f = lat.rest(*wall.shape[-2:])
    tots = torch.empty((steps, lat.B), dtype=dtype, device=wall.device)

    def advance(f, out):
        for i in range(out.shape[0]):
            f, out[i] = step(f, lat)
            if store is not None:
                f = f.to(store).to(dtype)
        return f

    done = 0
    if wall.is_cuda and steps >= graph_steps:
        state, chunk = f.clone(), torch.empty((graph_steps, lat.B), dtype=dtype, device=f.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the captured buffers
            advance(f.clone(), torch.empty_like(chunk))
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            state.copy_(advance(state.clone(), chunk))
        for done in range(0, steps - graph_steps + 1, graph_steps):
            graph.replay()
            tots[done:done + graph_steps] = chunk
        done += graph_steps
        f = state
    f = advance(f, tots[done:])
    return f, tots.to(torch.float64) / lat.n_fluid
