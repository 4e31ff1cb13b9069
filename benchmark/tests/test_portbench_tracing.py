"""The device timeline: busy time is a union (an overlapped copy counts
once), and idle time is named by the spans open during it."""

import pytest

from benchmark.tracing import Timeline, union_length


def _timeline(device, host, window_s):
    t = Timeline.__new__(Timeline)
    t.device, t.host, t.window_s = device, sorted(host), window_s
    t.busy_s = union_length([(s, s + d) for _, s, d in device]) / 1e9
    return t


def test_busy_is_a_union_and_idle_is_named_by_spans():
    ms = 1_000_000
    device = [("kernel_a", 0, 10 * ms), ("Memcpy HtoD (Pinned -> Device)", 5 * ms, 10 * ms),
              ("kernel_b", 40 * ms, 10 * ms), ("kernel_c", 50 * ms + 5_000, ms)]
    host = [(15 * ms, 30 * ms, "span.save_shard_cache"), (20 * ms, 25 * ms, "aten::copy_")]
    t = _timeline(device, host, 0.1)
    assert t.busy_s == pytest.approx(0.026)  # 15 + 10 + 1 ms, not 0.031: the copy overlaps kernel_a
    assert abs(t.idle_pct() - 74.0) < 1e-9
    assert Timeline.seconds(t.kernels()) == pytest.approx(0.021) and len(t.copies("HtoD")) == 1
    b = t.breakdown()
    idle = dict(b["idle_gaps"])
    assert idle["span.save_shard_cache"] == pytest.approx(0.015)  # of the 25 ms gap
    assert idle["no span open"] == pytest.approx(0.010)
    assert idle["gaps under 20 us"] == pytest.approx(5e-6)
    assert b["device_ops"][0] == ["kernel_a", 0.01]
