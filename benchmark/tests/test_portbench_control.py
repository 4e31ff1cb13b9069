"""Each cell's control (the program in the next precision below the
configuration's, ``benchmark/control.py``) comes out not correct at a size
a test run holds. On the CPU float32 products never run in TF32, so the
cluster cell's control runs on the card (decided inside the test); the
others run on the CPU."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.common import run_tiny

# the cluster cell at its own batch, K and widths over two shards: near-ties
# that TF32 decides wrongly need rows and centers in numbers
CLUSTER = {"config": {"cluster": {"batch_size": 1024, "ncentroids": 32}},
           "traffic": {"shards": 2, "rows_per_shard": 1000}}
CELLS = ["extract.fp32.decoded", "extract.bf16.decoded", "select.fp32.batch_mi",
         pytest.param("cluster.fp32.k32", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    overrides, hooks = control.mode_setup(workload, "control")
    if control.tf32 in hooks:
        if not torch.cuda.is_available():
            pytest.skip("TF32 products need a CUDA device")
        overrides = harness.merge(CLUSTER, overrides)

    def hook(stage):
        for h in hooks:
            h(stage)

    try:
        # the others on the CPU: at tiny shapes the card's int8 GEMM refuses
        # (``torch._int_mm`` takes more than 16 rows)
        result = run_tiny(workload, hook=hook, overrides=overrides,
                          cuda=control.tf32 in hooks)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not result["correct"], result["checks"]


def test_modes():
    assert control.mode_setup("select.fp32.batch_mi", "sound") == ({}, [])
    overrides, hooks = control.mode_setup("cluster.fp32.k32", "control")
    assert overrides["config"]["cluster"]["use_pallas"] is False and control.tf32 in hooks
    with pytest.raises(SystemExit):
        control.mode_setup("cluster.fp32.k32", "louder")
    assert harness.load_cell("cluster.fp32.k32").traffic["stage"] == "cluster"
