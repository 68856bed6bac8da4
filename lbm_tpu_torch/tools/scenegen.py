"""Scene generator: synthesize params/obstacle files in the reference format.

The reference ships four fixed scenes (dataSet/); this tool generates new
ones — the closed lid-driven box of the reference's geometry, a channel, and
the classic cylinder-wake benchmark — so users can exercise the solver on
their own cases.  Output files are directly consumable by
``lbm_tpu_torch run``, by ``lbm_tpu run`` and by the reference C solvers.
"""

from __future__ import annotations

import os

import numpy as np

from lbm_tpu_torch.params import LBMParams

PRESETS = ("cavity", "channel", "cylinder", "empty")


def make_mask(preset: str, ny: int, nx: int) -> np.ndarray:
    """Boolean obstacle mask for a preset geometry."""
    mask = np.zeros((ny, nx), dtype=bool)
    if preset == "empty":
        return mask
    # All presets are closed boxes like the reference scenes (top/bottom rows
    # and side columns blocked), so the periodic wrap is inert and the seam
    # padding of the sharded modes stays exact.
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    if preset == "cavity":
        return mask
    if preset == "channel":
        # Interior wall with a gap, like the 1024x1024 reference scene's
        # full-height wall at x=341 (dataSet/obstacles_1024x1024.dat).
        x = nx // 3
        gap = max(ny // 8, 2)
        mask[: ny // 2 - gap, x] = True
        mask[ny // 2 + gap :, x] = True
        return mask
    if preset == "cylinder":
        cy, cx = ny // 2, nx // 4
        r = max(min(ny, nx) // 10, 2)
        yy, xx = np.mgrid[0:ny, 0:nx]
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        return mask
    raise ValueError(f"unknown preset {preset!r}; choose from {PRESETS}")


def write_scene(
    out_dir: str,
    preset: str,
    params: LBMParams,
    name: str | None = None,
    mask: np.ndarray | None = None,
) -> tuple[str, str]:
    """Write ``input_<name>.params`` and ``obstacles_<name>.dat`` (the
    preset's mask, or ``mask``)."""
    os.makedirs(out_dir, exist_ok=True)
    name = name or f"{params.nx}x{params.ny}_{preset}"
    pfile = os.path.join(out_dir, f"input_{name}.params")
    ofile = os.path.join(out_dir, f"obstacles_{name}.dat")
    with open(pfile, "w") as fp:
        fp.write(
            f"{params.nx}\n{params.ny}\n{params.max_iters}\n"
            f"{params.reynolds_dim}\n{params.density}\n{params.accel}\n"
            f"{params.omega}\n"
        )
    if mask is None:
        mask = make_mask(preset, params.ny, params.nx)
    with open(ofile, "w") as fp:
        ys, xs = np.nonzero(mask)
        fp.writelines(f"{x} {y} 1\n" for x, y in zip(xs, ys))
    return pfile, ofile


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Generate a simulation scene")
    parser.add_argument("--grid", default="256x256", help="nx x ny, e.g. 512x512")
    parser.add_argument("--preset", default="cavity", choices=(*PRESETS, "golden"),
                        help="a geometry, or golden: the 1024x1024 reference scene of golden/ "
                        "(its own grid and parameters)")
    parser.add_argument("--iters", type=int, default=20000)
    parser.add_argument("--reynolds-dim", type=int, default=10)
    parser.add_argument("--density", type=float, default=0.1)
    parser.add_argument("--accel", type=float, default=0.005)
    parser.add_argument("--omega", type=float, default=1.85)
    parser.add_argument("--out-dir", default="scenes")
    parser.add_argument("--name", default=None)
    args = parser.parse_args(argv)

    if args.preset == "golden":
        from lbm_tpu_torch.tools.verify_device import golden_scene

        scene = golden_scene()
        pfile, ofile = write_scene(args.out_dir, "golden", scene.params, args.name,
                                   scene.obstacles)
        print(f"wrote {pfile} and {ofile}")
        return 0
    nx, ny = (int(v) for v in args.grid.split("x"))
    params = LBMParams(
        nx=nx, ny=ny, max_iters=args.iters, reynolds_dim=args.reynolds_dim,
        density=args.density, accel=args.accel, omega=args.omega,
    )
    pfile, ofile = write_scene(args.out_dir, args.preset, params, args.name)
    print(f"wrote {pfile} and {ofile}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
