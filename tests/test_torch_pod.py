"""The multi-process launcher (tools/pod.py) and the smoke worker
(tools/dist_smoke.py) on the CPU: the port of tests/test_distributed.py
(``pod --dryrun``: two ranks, each DIST_SMOKE_OK), ``run`` through
``pod --nproc 2`` against one process, tools/dryrun.py's relations on two
processes, and the refusals: a rank that fails or hangs stops every rank,
a missing peer times out, NCCL where ranks have no card of their own and a
``--devices`` the processes do not hold exit 1 with ``Error:``."""

import contextlib
import filecmp
import io
import os
import subprocess
import sys
import time
import warnings

import pytest

from lbm_tpu_torch import cli
from lbm_tpu_torch.params import LBMParams
from lbm_tpu_torch.tools import pod, scenegen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


def _pod(*args, env=None):
    e = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-m", "lbm_tpu_torch.tools.pod", *args], cwd=REPO,
                          env=e, capture_output=True, text=True, timeout=TIMEOUT + 30)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    p = LBMParams(nx=40, ny=30, max_iters=24, reynolds_dim=10, density=0.1, accel=0.005,
                  omega=1.85)
    return scenegen.write_scene(str(tmp_path_factory.mktemp("scene")), "cylinder", p, "pod")


def test_pod_dryrun():
    """``pod --dryrun``: two dist_smoke workers, each bitwise equal to one
    process, agreeing on tot_u (tests/test_distributed.py:40-67)."""
    proc = _pod("--dryrun", "--device", "cpu", "--timeout", str(TIMEOUT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("DIST_SMOKE_OK")]
    assert len(lines) == 2, proc.stdout
    assert len({ln.split("tot_u=")[1] for ln in lines}) == 1
    assert {ln.split()[1] for ln in lines} == {"process=0/2", "process=1/2"}


def test_pod_run_matches_one_process(scene, tmp_path):
    """``pod --nproc 2 ... --host-devices 2`` (async by default, as
    run_pod.sh) writes the files of one process over the same 4 shards, byte
    for byte, from rank 0 alone: one report, one set of files.  The ny of 30
    over 4 shards pads the last shard with live clones of shard 0's rows, a
    message between the two processes."""
    pfile, ofile = scene
    proc = _pod("--nproc", "2", "--timeout", str(TIMEOUT), pfile, ofile, "--device", "cpu",
                "--host-devices", "2", "--out-dir", str(tmp_path / "two"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("==done==") == 1 and "Variant:\t\t\tasync" in proc.stdout
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        assert cli.main(["run", pfile, ofile, "--device", "cpu", "--host-devices", "4",
                         "--variant", "async", "--out-dir", str(tmp_path / "one")]) == 0
    assert sorted(os.listdir(tmp_path / "two")) == ["av_vels.dat", "final_state.dat"]
    for f in ("av_vels.dat", "final_state.dat"):
        assert filecmp.cmp(tmp_path / "two" / f, tmp_path / "one" / f, shallow=False), f


def test_dryrun_relations_on_two_processes(tmp_path):
    """tools/dryrun.py's relations, with its sharded programs spread over 2
    processes x 2 shards: every one holds at ulp 0."""
    logs = [str(tmp_path / f"log{r}.txt") for r in range(2)]
    rc = pod.launch(2, ["-m", "lbm_tpu_torch.tools.dryrun", "--devices", "4", "--device", "cpu"],
                    timeout=TIMEOUT, logs=logs, cwd=REPO)
    text = [open(x).read() for x in logs]
    assert rc == 0, "".join(text)
    ok = [ln for ln in text[0].splitlines() if ln.startswith("dryrun ok:")]
    assert len(ok) == 21 and all("(cpu, 2 processes)" in ln for ln in ok), text[0]
    assert "dryrun ok:" not in text[1]


def test_failed_rank_stops_the_others():
    """A rank that exits non-zero ends the launch with its code at once;
    the rank still running is killed."""
    t0 = time.monotonic()
    rc = pod.launch(2, ["-c", "import os, sys, time\n"
                        "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)"],
                    timeout=TIMEOUT)
    assert rc == 3 and time.monotonic() - t0 < 30


def test_hung_ranks_time_out():
    t0 = time.monotonic()
    rc = pod.launch(2, ["-c", "import time; time.sleep(60)"], timeout=1)
    assert rc == 124 and time.monotonic() - t0 < 30


def test_missing_peer_times_out():
    """dist_smoke for rank 0 of 2 with no rank 1: the group never forms and
    the worker exits non-zero within its timeout."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.tools.dist_smoke", "--process-id", "0",
         "--num-processes", "2", "--coordinator", f"127.0.0.1:{pod.free_port()}",
         "--device", "cpu", "--timeout", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode != 0 and "DIST_SMOKE_OK" not in proc.stdout
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("what", ["nccl", "devices", "single-device"])
def test_refusals_exit_1(scene, tmp_path, what):
    """NCCL asked for where ranks have no card of their own (here the CPU;
    on a host whose ranks share a card the same), ``--devices`` other than
    the processes' shards, and a single-device variant: every rank exits 1
    with ``Error:``; the backend is never switched silently."""
    pfile, ofile = scene
    extra, env = {"nccl": ([], {"LBM_DIST_BACKEND": "nccl"}),
                  "devices": (["--devices", "3"], {}),
                  "single-device": (["--variant", "torch"], {})}[what]
    proc = _pod("--nproc", "2", "--timeout", str(TIMEOUT), pfile, ofile, "--device", "cpu",
                "--host-devices", "2", "--out-dir", str(tmp_path), *extra, env=env)
    assert proc.returncode == 1 and "Error:" in proc.stderr, proc.stdout + proc.stderr
    assert not os.listdir(tmp_path)
