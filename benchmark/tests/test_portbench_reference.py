"""The plain reference against the port's CPU path at tiny shapes: every
stage's run comes out correct, with limits far below the cells' own."""

import pytest

from benchmark.tests.common import run_tiny

TIGHT = {
    "extract.fp32.decoded": {"tap_err.slowfast": 1e-5, "tap_err.vggish": 1e-5},
    "cluster.fp32.k32": {"center_gap": 1e-5, "assign_gap": 1e-6},
    "select.fp32.batch_mi": {"pick_gap": 1e-6, "gain_err": 1e-5},
}


@pytest.mark.parametrize("workload", sorted(TIGHT))
def test_port_meets_reference_on_cpu(workload):
    result = run_tiny(workload, overrides={"limits": TIGHT[workload]})
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name
