"""What kernel K2's wrapper decides on the host, checked on the CPU: the
shapes and dtypes it hands to the kernel's two forms (float32, bfloat16) or
refuses, the plain version it runs for CPU tensors, and the ablation
variants of the kernel sources. The kernels themselves run only on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from acav100m_torch import ablate_k2
from acav100m_torch.ops import bottleneck_kernel as tbk


def _block(cin, inner, cout, proj, dtype=torch.float32):
    """Random weights; the weight matrices in ``dtype``, biases float32."""
    rng = np.random.RandomState(cin + inner + cout)

    def rnd(*shape):
        t = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return t.to(dtype) if len(shape) > 1 else t

    blk = {"aw": rnd(cin, inner), "ab": rnd(inner), "bw": rnd(3, 3, inner, inner),
           "bb": rnd(inner), "cw": rnd(inner, cout), "cb": rnd(cout)}
    if proj:
        blk.update(pw=rnd(cin, cout), pb=rnd(cout))
    return blk


@pytest.mark.parametrize("cin,inner,cout,proj", [
    (80, 64, 256, True),    # s2 slow, block 0
    (256, 64, 256, False),  # s2 slow, blocks 1 and 2
    (96, 32, 64, True),
])
def test_check_block_takes_supported_shapes(cin, inner, cout, proj):
    tbk._check_block(_block(cin, inner, cout, proj), cin, torch.device("cpu"))


@pytest.mark.parametrize("cin,inner,cout,proj", [
    (80, 48, 256, True),    # inner not 32 or 64
    (80, 128, 256, True),   # more product-b work than one item a warp
    (80, 64, 200, True),    # output channels not a multiple of 32
    (78, 64, 256, True),    # input channels not a multiple of 4
    (80, 64, 256, False),   # identity shortcut with Cin != Cout
])
def test_check_block_refuses_what_the_kernel_does_not_take(cin, inner, cout, proj):
    with pytest.raises(ValueError):
        tbk._check_block(_block(cin, inner, cout, proj), cin, torch.device("cpu"))


def test_cpu_tensors_take_the_plain_version():
    blocks = [_block(80, 64, 256, True), _block(256, 64, 256, False)]
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 6, 6, 80).astype(np.float32))
    before = tbk.fused_stage.launches
    out = tbk.fused_stage(x, blocks, stride=2)
    assert tbk.fused_stage.launches == before
    torch.testing.assert_close(out, tbk.fused_stage_ref(x, blocks, stride=2), rtol=0, atol=0)
    assert out.shape == (2, 3, 3, 256)


@pytest.mark.parametrize("name", sorted(ablate_k2.VARIANTS))
def test_ablation_variant_applies_to_the_kernel_source(name):
    src = ablate_k2.variant_source(ablate_k2.VARIANTS[name])
    assert (src == ablate_k2.SRC.read_text()) == (name == "full")
    assert 'extern "C" int bottleneck_block(' in src


@pytest.mark.parametrize("name", sorted(ablate_k2.VARIANTS_BF16))
def test_bf16_ablation_variant_applies_to_the_bf16_source(name):
    src = ablate_k2.variant_source(ablate_k2.VARIANTS_BF16[name], ablate_k2.SRC_BF16)
    assert (src == ablate_k2.SRC_BF16.read_text()) == (name == "full")
    assert 'extern "C" int bottleneck_block_bf16(' in src


@pytest.mark.parametrize("cin,inner,cout,proj", [
    (80, 64, 256, True),    # s2 slow, block 0
    (256, 64, 256, False),  # s2 slow, blocks 1 and 2
    (88, 32, 64, True),
])
def test_check_block_takes_bf16_matrices_with_float32_biases(cin, inner, cout, proj):
    blk = _block(cin, inner, cout, proj, torch.bfloat16)
    assert tbk._check_block(blk, cin, torch.device("cpu")) == torch.bfloat16
    assert tbk._check_block(_block(cin, inner, cout, proj), cin,
                            torch.device("cpu")) == torch.float32


def _mixed_weights():
    blk = _block(80, 64, 256, True, torch.bfloat16)
    blk["cw"] = blk["cw"].float()
    return blk


def _bf16_biases():
    blk = _block(80, 64, 256, True, torch.bfloat16)
    blk["ab"] = blk["ab"].to(torch.bfloat16)
    return blk


def _float16_block():
    return _block(80, 64, 256, True, torch.float16)


@pytest.mark.parametrize("make,cin", [
    (_mixed_weights, 80),     # bf16 and float32 weight matrices in one block
    (_bf16_biases, 80),       # a bias in bf16
    (_float16_block, 80),     # a form the kernel does not have
    (lambda: _block(84, 64, 256, True, torch.bfloat16), 84),  # bf16 Cin not a multiple of 8
])
def test_check_block_refuses_other_dtype_mixes(make, cin):
    with pytest.raises(ValueError):
        tbk._check_block(make(), cin, torch.device("cpu"))


def test_cpu_bf16_tensors_take_the_plain_version():
    blocks = [_block(80, 64, 256, True, torch.bfloat16),
              _block(256, 64, 256, False, torch.bfloat16)]
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 6, 6, 80).astype(np.float32))
    x = x.to(torch.bfloat16)
    before = tbk.fused_stage.launches, tbk.fused_stage_bf16.launches
    out = tbk.fused_stage(x, blocks, stride=2)
    direct = tbk.fused_stage_bf16(x, blocks, stride=2)
    assert (tbk.fused_stage.launches, tbk.fused_stage_bf16.launches) == before
    want = tbk.fused_stage_ref(x, blocks, stride=2)
    assert out.dtype == want.dtype == torch.bfloat16 and out.shape == (2, 3, 3, 256)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(direct, want, rtol=0, atol=0)


def test_bf16_plain_version_rounds_where_the_tpu_kernel_rounds():
    """The bf16 plain version on bf16-valued inputs equals the float32 one
    with a, b and the output rounded to bf16 and nothing else rounded."""
    blk = _block(80, 64, 256, True, torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 4, 80).astype(np.float32))
    x = x.to(torch.bfloat16)
    got = tbk.fused_stage_ref(x, [blk])
    w = {k: v.float() for k, v in blk.items()}
    xf = x.float()
    a = torch.relu(xf @ w["aw"] + w["ab"]).to(torch.bfloat16).float()
    b = torch.nn.functional.conv2d(a.permute(0, 3, 1, 2), w["bw"].permute(3, 2, 0, 1),
                                   padding=1).permute(0, 2, 3, 1)
    b = torch.relu(b + w["bb"]).to(torch.bfloat16).float()
    want = torch.relu(b @ w["cw"] + w["cb"] + (xf @ w["pw"] + w["pb"])).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bf16_form_refuses_float32_frames():
    x = torch.zeros((1, 4, 4, 80))
    with pytest.raises(ValueError):
        tbk.fused_stage_bf16(x, [_block(80, 64, 256, True, torch.bfloat16)])
