"""The kernel-timing module's device rows: kernels and copies count, the
operator rows and the spans that ``record_function`` labels put on the
device's timeline do not (they cover kernels that have rows of their own)."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from acav100m_torch import profiling


def _row(key, us, device=DeviceType.CUDA, **extra):
    return SimpleNamespace(key=key, self_device_time_total=us, device_type=device, **extra)


class _Profile:
    def __init__(self, rows):
        self.rows = rows

    def key_averages(self):
        return self.rows


@pytest.mark.parametrize("flagged", [True, False], ids=["is_user_annotation", "by_name"])
def test_device_rows_leave_out_annotated_spans(flagged):
    """An optimizer's span on the device is not a kernel, whether the
    profiler flags it or only its ``#`` label shows it."""
    extra = {"is_user_annotation": True} if flagged else {}
    rows = [_row("sm90_xmma_fprop_implicit_gemm", 700.0, is_user_annotation=False),
            _row("Memcpy HtoD (Pageable -> Device)", 50.0, is_user_annotation=False),
            _row("Optimizer.step#AdamW.step", 10020.0, **extra),
            _row("aten::convolution", 900.0, device=DeviceType.CPU, is_user_annotation=False),
            _row("void at::native::elementwise_kernel", 0.0, is_user_annotation=False)]
    keys = [e.key for e in profiling._device_events(_Profile(rows))]
    assert keys == ["sm90_xmma_fprop_implicit_gemm", "Memcpy HtoD (Pageable -> Device)"]


def test_device_rows_without_device_types_leave_out_operators_and_spans():
    """Where no row carries a device type, the rows with device time that
    are neither operators nor annotated spans are the kernels."""
    rows = [SimpleNamespace(key=k, self_device_time_total=us) for k, us in
            [("bn_fw_tr_1C11_kernel_NCHW", 300.0), ("aten::batch_norm", 300.0),
             ("ProfilerStep#3", 4000.0), ("aten::empty", 0.0)]]
    keys = [e.key for e in profiling._device_events(_Profile(rows))]
    assert keys == ["bn_fw_tr_1C11_kernel_NCHW"]


class _Event:
    def __init__(self, name, start, dur, device="CUDA", annotation=False):
        self._args = name, start, dur, device, annotation

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def duration_ns(self):
        return self._args[2]

    def device_type(self):
        return f"DeviceType.{self._args[3]}"

    def is_user_annotation(self):
        return self._args[4]


def test_busy_time_is_a_union_of_intervals():
    """A copy that overlaps a kernel counts once in the busy time; host
    events and the spans labels put on the device count not at all."""
    ms = 1_000_000
    events = [_Event("sm90_xmma_fprop_implicit_gemm", 0, 10 * ms),
              _Event("Memcpy HtoD (Pinned -> Device)", 5 * ms, 10 * ms),
              _Event("void at::native::elementwise_kernel", 40 * ms, 10 * ms),
              _Event("Memset (Device)", 60 * ms, ms),
              _Event("span.extract.forward", 0, 100 * ms, annotation=True),
              _Event("aten::convolution", 0, 100 * ms, device="CPU")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    busy, kernels, copies = profiling.busy_seconds(prof)
    assert busy == pytest.approx(0.026)  # 15 + 10 + 1 ms, not 0.031
    assert kernels == pytest.approx(0.020) and copies == pytest.approx(0.010)
