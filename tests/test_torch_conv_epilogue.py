"""The conv epilogue's wrapper on the CPU (``ops/conv_epilogue.py``): the
plain twin's arithmetic and what the wrapper refuses, for the kernel and
the twin alike. The kernel itself is held to the twin bit for bit on the
card (``tests/test_torch_cuda.py``, marker ``cuda``)."""

import pytest
import torch

from acav100m_torch import tracing
from acav100m_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_ref

CL = torch.channels_last_3d


def _cl(*shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 3).to(dtype).contiguous(memory_format=CL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_twin_sums_in_float32_and_rounds_once(dtype, residual, relu):
    y0 = _cl(2, 16, 3, 4, 5, dtype=dtype)
    bias = torch.randn(16, generator=torch.Generator().manual_seed(1))
    r = _cl(2, 16, 3, 4, 5, dtype=dtype, seed=2) if residual else None
    y = y0.clone()
    with tracing.enabled():
        out = conv_epilogue(y, bias, r, relu)
        assert "epilogue.launches" not in tracing.counters()  # the CPU runs the twin
    assert out is y and y.dtype == dtype and y.permute(0, 2, 3, 4, 1).is_contiguous()
    want = y0.float() + bias.view(-1, 1, 1, 1)
    if residual:
        want = want + r.float()
    if relu:
        want = want.clamp_min(0)
    assert torch.equal(y, want.to(dtype))
    assert torch.equal(conv_epilogue_ref(y0.clone(), bias, r, relu), y)


def test_twin_keeps_a_nan_through_relu():
    y = _cl(1, 8, 1, 1, 2)
    y[0, 3, 0, 0, 1] = float("nan")
    conv_epilogue(y, torch.zeros(8))
    assert torch.isnan(y[0, 3, 0, 0, 1]) and int(torch.isnan(y).sum()) == 1


def _refusals():
    y, bias = _cl(2, 16, 3, 4, 5), torch.zeros(16)
    ncdhw = torch.zeros((2, 16, 3, 4, 5))
    return {
        "c_not_a_multiple_of_8": (_cl(2, 12, 3, 4, 5), torch.zeros(12), None),
        "float16": (_cl(2, 16, 3, 4, 5, dtype=torch.float16), bias, None),
        "four_dims": (torch.zeros((2, 16, 4, 5)).contiguous(memory_format=torch.channels_last),
                      bias, None),
        "ncdhw_memory": (ncdhw, bias, None),
        "strided_channels": (_cl(2, 32, 3, 4, 5)[:, ::2], bias, None),
        "bias_shape": (y, torch.zeros(8), None),
        "bias_dtype": (y, bias.to(torch.bfloat16), None),
        "bias_strided": (y, torch.zeros(32)[::2], None),
        "residual_shape": (y, bias, _cl(2, 16, 3, 4, 6)),
        "residual_dtype": (y, bias, _cl(2, 16, 3, 4, 5, dtype=torch.bfloat16)),
        "residual_ncdhw": (y, bias, ncdhw),
        "residual_is_y": (y, bias, y),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refuses_what_the_kernel_does_not_take(case):
    y, bias, r = _refusals()[case]
    with pytest.raises(ValueError):
        conv_epilogue(y, bias, r)


def test_refuses_a_gradient_through_the_in_place_pass():
    y, bias = _cl(2, 16, 3, 4, 5), torch.zeros(16, requires_grad=True)
    with pytest.raises(ValueError):
        conv_epilogue(y, bias)
    with torch.no_grad():
        conv_epilogue(y, bias)
