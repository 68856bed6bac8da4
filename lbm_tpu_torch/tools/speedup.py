"""Speedup plot: measured MLUPS against the reference's published numbers
(``speedup``).

The counterpart of ``lbm_tpu/tools/speedup.py`` (the reference's
Visualization/plo.py): the reference's best per grid
(``tools/bench.REFERENCE_BEST_MLUPS``) beside the rates of this package's
``bench`` reports, and their ratio.  Needs matplotlib.
"""

from __future__ import annotations

import json

from lbm_tpu_torch.tools.bench import REFERENCE_BEST_MLUPS


def render_speedup(reports: list[dict], output: str) -> str:
    """Plot measured MLUPS against the reference's best per grid.

    ``reports`` are ``tools.bench.run_bench`` dicts (keys grid, value,
    device)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    grids = [r["grid"] for r in reports]
    ours = [r["value"] for r in reports]
    ref = [REFERENCE_BEST_MLUPS.get(g, float("nan")) for g in grids]
    devices = sorted({r.get("device") or "?" for r in reports})

    x = np.arange(len(grids))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    width = 0.38
    ax1.bar(x - width / 2, ref, width, label="reference best (80 cores, async MPI)")
    ax1.bar(x + width / 2, ours, width, label=f"lbm_tpu_torch ({', '.join(devices)})")
    ax1.set_xticks(x, grids)
    ax1.set_ylabel("MLUPS")
    ax1.set_title("Throughput")
    ax1.legend()

    speedup = [o / r if r else float("nan") for o, r in zip(ours, ref)]
    ax2.bar(x, speedup, color="tab:green")
    ax2.axhline(1.0, color="k", lw=0.8, ls="--")
    ax2.set_xticks(x, grids)
    ax2.set_ylabel("speedup vs reference best")
    ax2.set_title(f"Speedup vs. grid size ({', '.join(devices)} / 80 CPU cores)")
    for xi, s in zip(x, speedup):
        ax2.text(xi, s, f"{s:.1f}x", ha="center", va="bottom")
    fig.tight_layout()
    fig.savefig(output, dpi=130)
    plt.close(fig)
    return output


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Render a speedup plot from bench reports")
    parser.add_argument("reports", nargs="+", help="JSON bench report files (or JSON lines)")
    parser.add_argument("--output", default="speedup.png")
    args = parser.parse_args(argv)
    reports = []
    for path in args.reports:
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if line:
                    reports.append(json.loads(line))
    print(f"wrote {render_speedup(reports, args.output)}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
