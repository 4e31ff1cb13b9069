"""A run with its timed path broken underneath comes out not correct,
once for each fault a cell can have (``benchmark/faults.py``). The run
skips the look for a card and runs the program on the CPU at tiny shapes,
with the cells' own limits."""

import pytest

from benchmark import faults
from benchmark.tests.common import run_tiny

CASES = [("extract.fp32.decoded", "altered_answer"), ("extract.fp32.decoded", "half_batch"),
         ("cluster.fp32.k32", "unchanged_state"), ("cluster.fp32.k32", "half_batch"),
         ("cluster.fp32.k32", "altered_answer"), ("select.fp32.batch_mi", "altered_answer")]


def test_cases_cover_every_fault():
    stage = {"extract": "extract.fp32.decoded", "cluster": "cluster.fp32.k32",
             "select": "select.fp32.batch_mi"}
    assert sorted(CASES) == sorted((stage[s], f) for s, fs in faults.FAULTS.items() for f in fs)


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    stage = workload.split(".")[0]
    result = run_tiny(workload, hook=faults.FAULTS[stage][fault])
    assert not result["correct"], result["checks"]
