"""Without a card the benchmark fails and prints no result; on the card a
cell runs (card-only, decided inside the test)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def _run(workload, seconds="1"):
    return subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", workload,
                           "--seed", "4294967311", "--seconds", seconds, "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run("select.fp32.batch_mi")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_unknown_workload_fails():
    p = _run("no.such.cell")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _run("select.fp32.batch_mi", "2")
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
