"""Result validator — same contract as the reference harness (check/check.py).

Compares a produced ``av_vels.dat`` + ``final_state.dat`` pair against
reference files: coordinates must match, step counts must match, and the
maximum percentage deviation of both series must stay within tolerance
(default 1%, check/check.py:19-24).  The percentage is measured relative to
the *simulated* value, exactly as the reference computes it
(check/check.py:83-90: ``100*diff/(ref-diff)``).  Exit code 0 on pass, 1 on
fail.

Usable as a CLI (``python -m lbm_tpu_torch.tools.check``) with the reference's flag
names, or programmatically via :func:`check_files` / :func:`compare_series`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from lbm_tpu_torch.io.writers import read_av_vels, read_final_state


@dataclasses.dataclass
class SeriesDiff:
    max_diff_index: int
    max_diff: float
    max_diff_pcnt: float
    sim_val: float
    ref_val: float
    total_abs_diff: float
    # Grid coordinate of the max diff (final_state only): the first two
    # columns of the offending line, printed like the reference's
    # "(at coord (jj,ii))" report (check/check.py:120-129).
    coord: tuple[int, int] | None = None

    def passed(self, tolerance_pcnt: float) -> bool:
        return bool(
            np.isfinite(self.max_diff_pcnt)
            and abs(self.max_diff_pcnt) <= tolerance_pcnt
        )


def compare_series(ref: np.ndarray, sim: np.ndarray) -> SeriesDiff:
    """Percentage-difference comparison, relative to the simulated value
    (check/check.py:83-99)."""
    ref = np.asarray(ref, dtype=np.float64)
    sim = np.asarray(sim, dtype=np.float64)
    diff = ref - sim
    with np.errstate(divide="ignore", invalid="ignore"):
        diff_pcnt = 100.0 * diff / sim
    finite = np.isfinite(diff_pcnt)
    if not finite.all():
        # Any non-finite ratio fails; surface the first offender.
        idx = int(np.argmin(finite))
    else:
        idx = int(np.argmax(np.abs(diff_pcnt)))
    return SeriesDiff(
        max_diff_index=idx,
        max_diff=float(diff[idx]),
        max_diff_pcnt=float(diff_pcnt[idx]),
        sim_val=float(sim[idx]),
        ref_val=float(ref[idx]),
        total_abs_diff=float(np.sum(np.abs(diff))),
    )


@dataclasses.dataclass
class CheckResult:
    av_vels: SeriesDiff
    final_state: SeriesDiff
    tolerance_pcnt: float

    @property
    def passed(self) -> bool:
        return self.av_vels.passed(self.tolerance_pcnt) and self.final_state.passed(
            self.tolerance_pcnt
        )


def check_files(
    ref_av_vels: str,
    ref_final_state: str,
    av_vels: str,
    final_state: str,
    tolerance_pcnt: float = 1.0,
) -> CheckResult:
    ref_av = read_av_vels(ref_av_vels)
    sim_av = read_av_vels(av_vels)
    ref_fs = read_final_state(ref_final_state)
    sim_fs = read_final_state(final_state)

    if ref_fs.shape[0] != sim_fs.shape[0] or np.any(ref_fs[:, 0:2] != sim_fs[:, 0:2]):
        raise ValueError("Final state files coordinates were not the same")
    if ref_av.size != sim_av.size:
        raise ValueError("Different number of steps in av_vels files")

    fs_diff = compare_series(ref_fs[:, 2], sim_fs[:, 2])
    fs_diff.coord = (
        int(sim_fs[fs_diff.max_diff_index, 0]),
        int(sim_fs[fs_diff.max_diff_index, 1]),
    )
    return CheckResult(
        av_vels=compare_series(ref_av, sim_av),
        final_state=fs_diff,
        tolerance_pcnt=tolerance_pcnt,
    )


def _report(name: str, d: SeriesDiff, where: str) -> None:
    print(f"Total difference in {name} : {d.total_abs_diff:.12E}")
    if d.coord is not None:
        loc = f"at coord ({d.coord[0]},{d.coord[1]})"
    else:
        loc = f"{where} {d.max_diff_index}"
    print(f"Biggest difference ({loc}) : {d.max_diff:.12E}")
    print(f"  {d.sim_val:.12E} vs. {d.ref_val:.12E} = {d.max_diff_pcnt:.2g}%")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate LBM outputs against reference results",
        fromfile_prefix_chars="@",
    )
    parser.add_argument("--tolerance", nargs=1, default=[1.0], type=float)
    parser.add_argument("--ref-av-vels-file", nargs=1, required=True)
    parser.add_argument("--ref-final-state-file", nargs=1, required=True)
    parser.add_argument("--av-vels-file", nargs=1, required=True)
    parser.add_argument("--final-state-file", nargs=1, required=True)
    args = parser.parse_args(argv)

    try:
        result = check_files(
            args.ref_av_vels_file[0],
            args.ref_final_state_file[0],
            args.av_vels_file[0],
            args.final_state_file[0],
            tolerance_pcnt=args.tolerance[0],
        )
    except ValueError as e:
        print(str(e))
        return 1

    _report("av_vels", result.av_vels, "at step")
    print()
    _report("final_state", result.final_state, "at cell")
    print()

    failed = False
    if not result.final_state.passed(result.tolerance_pcnt):
        print("final state failed check")
        failed = True
    if not result.av_vels.passed(result.tolerance_pcnt):
        print("av_vels failed check")
        failed = True
    if not failed:
        print("Both tests passed!")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
