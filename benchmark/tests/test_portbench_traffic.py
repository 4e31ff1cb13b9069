"""Seeded traffic repeats bit for bit, and another seed changes it but
not its sizes."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.common import TINY


def _traffic(workload, seed, work):
    spec = harness.load_cell(workload, TINY[workload])
    work.mkdir()
    ctx = SimpleNamespace(config=spec.config, traffic=spec.traffic, limits=spec.limits,
                          seed=seed, work=work, device=torch.device("cpu"), cuda=False,
                          subseed=lambda label: harness.subseed(seed, label))
    stage = harness.load_module(harness.BENCH / "stages" / f"{spec.traffic['stage']}.py").Stage(ctx)
    stage.make_traffic()
    digest = {}
    for path in sorted(work.rglob("*")):
        if path.is_file():
            digest[path.relative_to(work).as_posix()] = hashlib.sha256(path.read_bytes()).hexdigest()
    arrays = [getattr(stage, a) for a in ("frames", "audio", "assignments") if hasattr(stage, a)]
    arrays += list(getattr(stage, "x", []))
    return digest, [np.asarray(a) for a in arrays]


@pytest.mark.parametrize("workload", ["extract.fp32.decoded", "cluster.fp32.k32",
                                      "select.fp32.batch_mi"])
def test_same_seed_same_bytes(workload, tmp_path):
    a, arr_a = _traffic(workload, 2 ** 33 + 5, tmp_path / "a")
    b, arr_b = _traffic(workload, 2 ** 33 + 5, tmp_path / "b")
    c, arr_c = _traffic(workload, 2 ** 33 + 6, tmp_path / "c")
    assert a == b and all(np.array_equal(x, y) for x, y in zip(arr_a, arr_b))
    assert [x.shape for x in arr_a] == [x.shape for x in arr_c]
    assert not all(np.array_equal(x, y) for x, y in zip(arr_a, arr_c))
