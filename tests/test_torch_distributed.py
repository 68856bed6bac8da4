"""lbm_tpu_torch's multi-process form: the sharded programs spread over two
gloo processes of the CPU, held bitwise (``torch.equal``) against the same
program's shards driven by one process.

One launch of two ranks (tools/pod.py ``launch``) runs this file as its
worker: every case below builds its program on the mesh of the two
processes and on one process's mesh of the same global shards, runs both
and records whether fields and per-step tot_u agree bitwise; then the
``run`` CLI under the group (plain, frames with debug, checkpoints and a
resume, ``--plan``, ``--profile`` (every rank's trace, and a summary that
fails on rank 1) and ``--divergence``), each rank into its own directory.
The tests read the ranks' records and hold rank 0's files byte for byte
against one-process runs of the same global shards made here; rank 1
writes nothing.  Card tests: the same
programs on one card shared by two gloo processes, and four NCCL
processes on four cards (``-k cards``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_distributed.py
"""

import contextlib
import filecmp
import io
import json
import os
import pathlib
import sys
import time
import warnings

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the worker runs this file as a script
    sys.path.insert(0, str(REPO))

from lbm_tpu_torch import cli  # noqa: E402
from lbm_tpu_torch.models import driver  # noqa: E402
from lbm_tpu_torch.params import LBMParams  # noqa: E402
from lbm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lbm_tpu_torch.parallel import modes  # noqa: E402
from lbm_tpu_torch.tools import dryrun, pod, scenegen  # noqa: E402

STEPS = 12
LAUNCH_TIMEOUT = 240  # seconds the two ranks may take


def _open(ny, nx=128):
    """An open periodic seam (only an interior block): ny not a multiple of
    the shards pads the last shard with live clones of shard 0's rows."""
    m = np.zeros((ny, nx), dtype=bool)
    m[5:7, 8:10] = True
    return m


def _cases():
    """name -> (local shards, ny, mode, staleness, storage, LBM_CA_ENGINE,
    open seam): lbm_tpu's 8-row-per-shard box over 2 x local shards."""
    out = {}
    for local in (2, 4):
        tag = f"2x{local}"
        for mode, k in (("sync", 1), ("overlap", 1), ("async", 1), ("async", 2),
                        ("chunked", 2)):
            out[f"{tag}-{mode}-{k}"] = (local, 16 * local, mode, k, "f32", None, False)
        for k in (2, 4):
            for engine in modes.CA_ENGINES:
                out[f"{tag}-ca-{k}-{engine}"] = (local, 16 * local, "ca", k, "f32", engine, False)
        out[f"{tag}-sync-i16"] = (local, 16 * local, "sync", 1, "i16", None, False)
        out[f"{tag}-ca-4-i16"] = (local, 16 * local, "ca", 4, "i16", None, False)
        # Open seam: 2 (2x2) or 4 (2x4) pad rows on the last shard, refreshed
        # from shard 0 in the other process.
        for mode, k in (("sync", 1), ("overlap", 1), ("async", 2), ("chunked", 2)):
            out[f"{tag}-open-{mode}-{k}"] = (local, 16 * local - local, mode, k, "f32", None, True)
    return out


CASES = _cases()
SCENE = dict(nx=48, ny=32, steps=40)
# The CLI runs of the worker: name -> run flags (each rank writes into
# <out>/<name>-rank<r>; frames every 10 steps with --debug; checkpoints
# every 20 steps, then a resume from step 20).
RUNS = {
    "plain": ["--variant", "async"],
    "frames": ["--variant", "ca", "--frame-interval", "10", "--debug"],
    "ckpt": ["--variant", "chunked", "--checkpoint-every", "20"],
    "resume": ["--variant", "chunked"],
}


def _write_scene(root):
    """The runs' scene files in ``root``, written once before the ranks start."""
    p = LBMParams(nx=SCENE["nx"], ny=SCENE["ny"], max_iters=SCENE["steps"], reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    scenegen.write_scene(str(root), "cylinder", p, "dist")


def _run_args(root, name, out_dir, extra=()):
    pfile, ofile = (str(pathlib.Path(root) / f) for f in ("input_dist.params",
                                                           "obstacles_dist.dat"))
    args = ["run", pfile, ofile, "--device", "cpu", "--host-devices", "2",
            "--out-dir", str(out_dir), *RUNS[name], *extra]
    if name == "ckpt":
        args += ["--checkpoint-dir", str(pathlib.Path(out_dir) / "ck")]
    if name == "resume":  # every rank reads rank 0's checkpoint
        args += ["--resume", str(pathlib.Path(out_dir).parent / "ckpt-rank0" / "ck"
                                 / "ckpt_00000020.npz")]
    return args


def _build(mesh, case):
    local, ny, mode, k, storage, engine, open_seam = case
    p = LBMParams(nx=128, ny=ny, max_iters=STEPS, reynolds_dim=10, density=0.1, accel=0.005,
                  omega=1.85)
    obst = _open(ny) if open_seam else dryrun.toy_scene(ny, 128).obstacles
    with warnings.catch_warnings(), dryrun.env(LBM_CA_ENGINE=engine):
        warnings.simplefilter("ignore", UserWarning)  # the stale-fraction warning
        return modes.build_sharded_program(p, obst, mesh, mode, k, storage=storage)


def _failing_summary(*args, **kwargs):
    raise ValueError("the trace summary failed (injected on rank 1)")


def worker(out: str) -> int:
    """One rank: every case, then the CLI runs; records into
    ``out/rank<r>.json``."""
    out = pathlib.Path(out)
    summary = driver._profile_summary
    proc = mesh_lib.join("cpu", timeout_s=120)
    record = {"cases": {}, "runs": {}}
    try:
        for name, case in CASES.items():
            local = case[0]
            got = []
            for mesh in (mesh_lib.make_row_mesh(None, ["cpu"] * local, proc.rank, proc.world),
                         mesh_lib.make_row_mesh(None, ["cpu"] * (local * proc.world))):
                prog = _build(mesh, case)
                st, tots = prog.make_run_all(STEPS)(prog.init_state)
                st1, tot1 = prog.step(prog.init_state)  # step() and its copy-out too
                got.append((prog.f_of(st), tots, prog.f_of(st1), tot1, prog.variant))
            (f, t, f1, t1, v), (rf, rt, rf1, rt1, _) = got
            record["cases"][name] = {
                "variant": v, "f": torch.equal(f, rf), "tot_u": torch.equal(t, rt),
                "step": torch.equal(f1, rf1) and torch.equal(t1, rt1),
                "max_df": float((f - rf).abs().max())}
        for name in RUNS:
            d = out / f"{name}-rank{proc.rank}"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(_run_args(out, name, d))
            record["runs"][name] = {"rc": rc, "stdout": buf.getvalue()}
        for name, extra in (("plan", ["--plan"]), ("profile", ["--profile", str(out / "tr")]),
                            ("divergence", ["--divergence"]),
                            ("profile-fail", ["--profile", str(out / "tr-fail")])):
            buf, err = io.StringIO(), io.StringIO()
            if name == "profile-fail" and proc.rank == 1:
                driver._profile_summary = _failing_summary
            t0 = time.monotonic()
            try:
                with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                    rc = cli.main(_run_args(out, "plain", out / f"{name}-rank{proc.rank}",
                                            extra))
            finally:
                driver._profile_summary = summary
            record["runs"][name] = {"rc": rc, "stdout": buf.getvalue(), "stderr": err.getvalue(),
                                    "seconds": time.monotonic() - t0}
    finally:
        mesh_lib.leave()
    (out / f"rank{proc.rank}.json").write_text(json.dumps(record))
    return 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' records, and the directory they wrote into."""
    out = tmp_path_factory.mktemp("dist")
    _write_scene(out)
    logs = [str(out / f"log{r}.txt") for r in range(2)]
    rc = pod.launch(2, [str(pathlib.Path(__file__)), "worker", str(out)],
                    timeout=LAUNCH_TIMEOUT, logs=logs, cwd=str(out))
    text = "".join(pathlib.Path(x).read_text() for x in logs)
    assert rc == 0, text
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)], out


@pytest.fixture(scope="module")
def one_process(ranks, tmp_path_factory):
    """The same CLI runs by one process over the same 4 global shards."""
    _, out = ranks
    ref = tmp_path_factory.mktemp("one")
    texts = {}
    for name in RUNS:
        args = _run_args(out, name, ref / f"{name}-rank0")
        args[args.index("--host-devices") + 1] = "4"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            assert cli.main(args) == 0
        texts[name] = buf.getvalue()
    args = _run_args(out, "plain", ref / "divergence-rank0", ["--divergence"])
    args[args.index("--host-devices") + 1] = "4"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        assert cli.main(args) == 0
    texts["divergence"] = buf.getvalue()
    return ref, texts


@pytest.mark.parametrize("name", list(CASES))
def test_processes_match_one_process(ranks, name):
    """Fields and per-step tot_u of the program over 2 processes equal, on
    both ranks, the same program's run by one process over the same global
    shards, through a runner and through ``step``."""
    records, _ = ranks
    for r, rec in enumerate(records):
        res = rec["cases"][name]
        assert res["f"] and res["tot_u"] and res["step"], (r, res)


def _files(d):
    d = pathlib.Path(d)
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


@pytest.mark.parametrize("name", list(RUNS))
def test_run_writes_rank0_files_identical_to_one_process(ranks, one_process, name):
    """``run`` under the group: rank 0's files (av_vels.dat,
    final_state.dat, frames, checkpoints; after a resume from step 20) equal
    byte for byte those of one process over the same 4 shards, its report
    names the same variant, and rank 1 writes and prints nothing."""
    records, out = ranks
    ref, texts = one_process
    for r in range(2):
        assert records[r]["runs"][name]["rc"] == 0, records[r]["runs"][name]
    got, want = out / f"{name}-rank0", ref / f"{name}-rank0"
    names = _files(want)
    assert names and _files(got) == names
    for f in names:
        if f.endswith(".npz"):
            a, b = np.load(got / f), np.load(want / f)
            assert all(np.array_equal(a[k], b[k]) for k in b.files), f
        else:
            assert filecmp.cmp(got / f, want / f, shallow=False), f
    assert not (out / f"{name}-rank1").exists()
    assert records[1]["runs"][name]["stdout"] == ""
    variant = [ln for ln in texts[name].splitlines() if ln.startswith("Variant:")]
    assert variant and variant[0] in records[0]["runs"][name]["stdout"]
    if name == "frames":  # the debug report: every step's av velocity and density
        debug = [ln for ln in texts[name].splitlines() if ln.startswith(("av velocity",
                                                                        "tot density"))]
        assert len(debug) == 2 * SCENE["steps"]
        assert all(ln in records[0]["runs"][name]["stdout"] for ln in debug)


def test_plan_names_the_processes(ranks):
    records, _ = ranks
    plan = records[0]["runs"]["plan"]
    assert plan["rc"] == 0 and records[1]["runs"]["plan"]["stdout"] == ""
    assert "processes: 2 x 2 local shard(s), this rank 0; backend gloo" in plan["stdout"]
    assert "shards: 4 x 8 rows" in plan["stdout"] and "program: async" in plan["stdout"]


def test_profile_traces_every_rank(ranks):
    """``run --profile DIR`` under the group: each rank writes its own
    trace, ``DIR/rank<r>/trace.json``, a Chrome trace of its compute
    bracket; no rank writes ``DIR/trace.json``."""
    records, out = ranks
    for r, rec in enumerate(records):
        assert rec["runs"]["profile"]["rc"] == 0, rec["runs"]["profile"]
        trace = json.loads((out / "tr" / f"rank{r}" / "trace.json").read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert "c10d::send" in names and "c10d::allgather_" in names  # the rank's messages
    assert not (out / "tr" / "trace.json").exists()


def test_profile_rank0_files_and_report(ranks, one_process):
    """Rank 0's files equal the unprofiled one-process run's over the same
    4 shards byte for byte; its report has one ``Profile:`` line per rank,
    in rank order, each naming that rank's trace; rank 1 writes and prints
    nothing."""
    records, out = ranks
    ref, _ = one_process
    for f in ("final_state.dat", "av_vels.dat"):
        assert filecmp.cmp(out / "profile-rank0" / f, ref / "plain-rank0" / f, shallow=False), f
    lines = [ln for ln in records[0]["runs"]["profile"]["stdout"].splitlines()
             if ln.startswith("Profile:")]
    assert len(lines) == 2
    for r, ln in enumerate(lines):
        assert f"rank {r}: 0 CUDA kernel events" in ln
        assert ln.endswith(f"trace {out / 'tr' / f'rank{r}' / 'trace.json'}")
    assert records[1]["runs"]["profile"]["stdout"] == ""
    assert not (out / "profile-rank1").exists()


def test_profile_failure_on_one_rank_stops_every_rank(ranks):
    """A summary that raises on rank 1 makes both ranks exit 1 with
    ``Error:`` at once, through the gather's ok flag, not after the
    group's timeout: rank 1 says why, rank 0 names rank 1."""
    records, out = ranks
    fail = [rec["runs"]["profile-fail"] for rec in records]
    assert all(run["rc"] == 1 and run["seconds"] < 60 for run in fail), fail
    assert "Error: the trace summary failed (injected on rank 1)" in fail[1]["stderr"]
    assert "Error: --profile failed on rank(s) [1]" in fail[0]["stderr"]
    assert not (out / "profile-fail-rank0").exists()


def test_divergence_rank0_matches_one_process(ranks, one_process):
    """``run --divergence`` under the group: rank 0's divergence.csv is
    byte-identical to one process's over the same 4 global shards and its
    summary line the same; rank 1 writes and prints nothing."""
    records, out = ranks
    ref, texts = one_process
    runs = [rec["runs"]["divergence"] for rec in records]
    assert [run["rc"] for run in runs] == [0, 0], runs
    assert filecmp.cmp(out / "divergence-rank0" / "divergence.csv",
                       ref / "divergence-rank0" / "divergence.csv", shallow=False)
    summary = [ln for ln in texts["divergence"].splitlines() if ln.startswith("divergence over")]
    assert len(summary) == 1 and "(async, staleness=1, 4 shards)" in summary[0]
    assert summary[0] in runs[0]["stdout"].splitlines()
    assert runs[1]["stdout"] == "" and not (out / "divergence-rank1").exists()


# The modes of tests/test_torch_parallel.py's cards test: (mode, staleness, storage).
CARD_MODES = [("sync", 1, "f32"), ("overlap", 1, "f32"), ("async", 2, "f32"),
              ("chunked", 2, "f32"), ("sync", 1, "i16"), ("ca", 4, "f32"), ("ca", 8, "i16")]


def smoke_on_cards(tmp_path, nproc: int, local: int, mode: str, k: int, storage: str,
                   env: dict) -> tuple[int, list[str]]:
    """tools/dist_smoke.py on the card(s): ``nproc`` ranks x ``local``
    shards, 24 steps; (launch code, each rank's output)."""
    logs = [str(tmp_path / f"log{r}.txt") for r in range(nproc)]
    rc = pod.launch(nproc, ["-m", "lbm_tpu_torch.tools.dist_smoke", "--device", "cuda",
                            "--local-devices", str(local), "--mode", mode, "--staleness", str(k),
                            "--storage", storage, "--steps", "24"],
                    timeout=LAUNCH_TIMEOUT, logs=logs, cwd=str(REPO), env=env)
    return rc, [pathlib.Path(x).read_text() for x in logs]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,storage", CARD_MODES)
def test_gloo_processes_share_the_card(cuda_device, tmp_path, mode, k, storage):
    """Two gloo processes x 2 shards of the one card (K1-slab, K6, K7, K8
    on the card, ghosts through pinned host buffers) give, on both ranks,
    the fields and sums of one process over the same 4 shards, bitwise."""
    rc, outs = smoke_on_cards(tmp_path, 2, 2, mode, k, storage,
                              env={"CUDA_VISIBLE_DEVICES": "0"})
    assert rc == 0, "".join(outs)
    for r, text in enumerate(outs):
        assert f"DIST_SMOKE_OK process={r}/2 devices=4 mode={mode}" in text, text
        assert "backend=gloo" in text


@pytest.mark.cuda
def test_nccl_refused_where_ranks_share_the_card(cuda_device, tmp_path):
    rc, outs = smoke_on_cards(tmp_path, 2, 2, "sync", 1, "f32",
                              env={"CUDA_VISIBLE_DEVICES": "0", "LBM_DIST_BACKEND": "nccl"})
    assert rc == 1 and "Error: LBM_DIST_BACKEND=nccl needs a card for every rank" in "".join(outs)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "worker":
        sys.exit(worker(sys.argv[2]))
    sys.exit(f"usage: {sys.argv[0]} worker OUT_DIR")
