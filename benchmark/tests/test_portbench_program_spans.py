"""The per-layer metrics read from the program's own spans and counters
(``acav100m_torch.tracing``) read numbers in a traced run of their cells,
here on the CPU at tiny shapes."""

import pytest

from .common import run_tiny

METRICS = {
    "extract.fp32.decoded": ("extract.feed_wait_ms_per_batch", "extract.save_ms_per_batch",
                             "extract.cache_mb_per_batch"),
    "select.fp32.batch_mi": ("select.dispatch_us_per_iter", "select.bookkeeping_us_per_iter",
                             "select.host_reads_per_iter"),
}


@pytest.mark.parametrize("workload", sorted(METRICS))
def test_program_span_metrics_read_numbers_when_traced(workload):
    result = run_tiny(workload, trace=True)
    assert result["correct"], result["checks"]
    got = {name: result["metrics"].get(name, {}).get("value") for name in METRICS[workload]}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    if workload.startswith("select"):
        assert got["select.host_reads_per_iter"] == 2.0


@pytest.mark.parametrize("workload", sorted(METRICS))
def test_untraced_runs_report_no_program_span_metric(workload):
    result = run_tiny(workload, trace=False)
    assert not set(METRICS[workload]) & set(result["metrics"])
