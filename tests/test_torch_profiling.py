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
