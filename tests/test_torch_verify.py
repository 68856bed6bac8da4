"""lbm_tpu_torch's verify artifact (tools/verify_device.py) in its CPU
regime: the wrappers run their plain versions, held against the twin at
reduced extents (``TOLERANCE["cpu-plain"]``: 5e-7 on float32 fields, 0
quantization steps on int16), and a short golden prefix of the 1024^2
reference scene rebuilt from golden/.  The card regime's bitwise claim is
the smoke test's phase (a) on the H100."""

import json

import pytest

from lbm_tpu_torch.tools import verify_device

# The kernel forms of PERF.md's kernel table: B1-B10 as CUDA kernels, and
# the ensemble's batched K1 and K2 and its cluster kernel K11.
KERNEL_FORMS = {"K1", "K1-i16", "K1-slab", "K1-slab-i16", "K2", "K3", "K3-i16", "K4", "K4-i16",
                "K4-slab", "K4-slab-i16", "K5", "K5-i16", "K6", "K7", "K8", "K8-i16", "K9",
                "K10", "K1-batch", "K2-batch", "K11"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """``main --device cpu`` once: (the file it wrote, the line it printed)."""
    out = tmp_path_factory.mktemp("verify") / "VERIFY_H100.json"
    mp = pytest.MonkeyPatch()
    mp.setenv("LBM_VERIFY_OUT", str(out))
    try:
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = verify_device.main(["--device", "cpu"])
    finally:
        mp.undo()
    return rc, json.loads(out.read_text()), buf.getvalue()


def test_verify_writes_the_report_it_prints(artifact):
    rc, report, printed = artifact
    assert rc == 0
    lines = printed.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == report


def test_verify_schema(artifact):
    _, report, _ = artifact
    assert set(report["probes"]) == KERNEL_FORMS == set(verify_device.PROBES)
    for key in ("regime", "card", "device", "torch", "cuda", "commit", "sources_sha256",
                "tolerance", "golden_prefix", "golden_prefix_i16", "ok"):
        assert key in report, key
    for probe in report["probes"].values():
        assert {"shape", "steps", "max_abs", "bitwise", "ok", "reference"} <= set(probe)
        assert probe["bitwise"] == (probe["max_abs"] == 0.0)
    for key in ("golden_prefix", "golden_prefix_i16"):
        assert {"steps", "variant", "max_pct", "ok"} <= set(report[key])
    assert report["sources_sha256"] == verify_device.source_digest()


def test_verify_cpu_regime_ok(artifact):
    _, report, _ = artifact
    assert report["regime"] == "cpu-plain" and report["card"] is None
    assert report["tolerance"] == verify_device.TOLERANCE["cpu-plain"]
    assert report["ok"] is True
    assert all(p["ok"] for p in report["probes"].values())
    assert report["golden_prefix"]["max_pct"] < 1.0
    assert report["golden_prefix_i16"]["max_pct"] < 1.0
    assert report["golden_prefix_i16"]["variant"] == "cuda-inplace-i16"


def test_verify_without_a_card_refuses_the_card_regime(monkeypatch, tmp_path, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LBM_VERIFY_OUT", str(tmp_path / "v.json"))
    assert verify_device.main([]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report == {"ok": False, "error": "ValueError: no CUDA device"}
