"""What kernel K2's wrapper decides on the host, checked on the CPU: the
shapes it hands to the kernel or refuses, the plain version it runs for CPU
tensors, and the ablation variants of the kernel source. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from acav100m_torch import ablate_k2
from acav100m_torch.ops import bottleneck_kernel as tbk


def _block(cin, inner, cout, proj):
    rng = np.random.RandomState(cin + inner + cout)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

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
