"""The command as the driver runs it: without a card it fails and prints no
result; in a directory that holds only BENCHMARK.json and portbench/ it
fails too. On a card (marked `cuda`), a shrunk cell runs end to end."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import spec
from portbench.tests import tiny

ARGS = ["--workload", "dlrm.train.zipf", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (json.JSONDecodeError, TypeError):
            pass
    return False


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not reachable")
    p = _run(spec.ROOT)
    assert p.returncode != 0 and not _has_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_harness_alone_fails(tmp_path):
    shutil.copytree(spec.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and not _has_result(p.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dlrm.train.zipf", "dcn.train.zipf"])
def test_shrunk_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench import run
    r = run.run_cell(tiny.cell(name), 2**31 + 5, 1.0, False,
                     torch.device("cuda", 0))
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["metrics"]["train_examples_per_s"]["value"] > 0
