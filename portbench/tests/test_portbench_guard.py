"""What a run refuses: JAX in the process, by whole top-level name, and a
machine without the CUDA cards the cell asks for."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from portbench.tests.helpers import REPO
from portbench import guard


@pytest.mark.parametrize("names,found", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["lbm_tpu", "lbm_tpu.ops.fused_jnp"], ["lbm_tpu"]),
    (["lbm_tpu_torch", "lbm_tpu_torch.models.driver", "jaxtyping", "torch"], []),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert guard.forbidden_modules(names) == found


def run_py(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = run_py(REPO, "--workload", "refbox.1024", "--seed", "5", "--seconds", "1",
                 "--trace", "0")
    assert res.returncode == 3 and res.stdout == ""
    assert "no CUDA device" in res.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run_py(tmp_path, "--workload", "refbox.1024", "--seed", "5", "--seconds", "1",
                 "--trace", "0")
    assert res.returncode != 0 and res.stdout == ""
