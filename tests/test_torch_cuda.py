"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device, nvcc and the sm_90a target (an H100); they
carry the ``cuda`` marker and skip elsewhere. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from acav100m_torch import tracing
from acav100m_torch.ops import mi
from acav100m_torch.ops.bottleneck_kernel import (fused_stage, fused_stage_bf16, fused_stage_ref,
                                                  pack_block_f32)
from acav100m_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_ref
from acav100m_torch.ops.kmeans_kernel import fused_assign_update, fused_assign_update_ref
from acav100m_torch.ops.nonlocal_kernel import nonlocal_core, nonlocal_core_ref
from acav100m_torch.ops.pairing import get_cluster_pairing

from . import batch_mi_states as bm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,d,b", [
    (3, 8, 48, 100), (2, 4, 40, 64), (10, 32, 2304, 1000),
    (2, 40, 36, 70),   # K over one pass of 32 centers
    (3, 8, 30, 50),    # D not a multiple of 4: the wrapper pads it
])
def test_k1_matches_plain(card, m, k, d, b):
    gen = torch.Generator().manual_seed(b)
    batch = torch.randn((m, b, d), generator=gen).to(card)
    centers = torch.randn((m, k, d), generator=gen).to(card)
    counts = torch.randint(0, 400, (m, k), generator=gen).float().to(card)
    threshold = 147.0
    with tracing.enabled():
        best, c, dl, mean = fused_assign_update(centers, counts, batch, threshold)
    assert tracing.counters()["k1.launches"] == 1
    best_p, c_p, dl_p, mean_p = fused_assign_update_ref(centers, counts, batch, threshold)
    # random data in these sizes has no near-ties at 1e-4
    assert torch.equal(best, best_p)
    assert torch.equal(c, c_p)
    torch.testing.assert_close(dl, dl_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mean, mean_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dims,k,b", [
    ((88, 352, 704, 1408, 2304, 64, 128, 256, 512, 128), 32, 1024),  # the main path
    ((48, 30, 21), 4, 100),  # ragged widths, path A's K
    ((700, 40), 40, 64),     # split columns, two passes of centers
])
def test_k1_dims_skips_padding_bit_for_bit(card, dims, k, b):
    gen = torch.Generator().manual_seed(k + b)
    m, d = len(dims), max(dims)
    mask = (torch.arange(d)[None, :] < torch.tensor(dims)[:, None]).float()[:, None, :]
    batch = (torch.randn((m, b, d), generator=gen) * mask).to(card)
    centers = (torch.randn((m, k, d), generator=gen) * mask).to(card)
    counts = torch.randint(0, 400, (m, k), generator=gen).float().to(card)
    with tracing.enabled():
        out = fused_assign_update(centers, counts, batch, 147.0, dims=dims)
        again = fused_assign_update(centers, counts, batch, 147.0, dims=dims)
        padded = fused_assign_update(centers, counts, batch, 147.0)
    assert tracing.counters()["k1.launches"] == 3
    for u, v, w in zip(out, again, padded):
        assert torch.equal(u, v) and torch.equal(u, w)
    best_p, c_p, dl_p, mean_p = fused_assign_update_ref(centers, counts, batch, 147.0)
    assert torch.equal(out[0], best_p) and torch.equal(out[1], c_p)
    torch.testing.assert_close(out[2], dl_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[3], mean_p, rtol=1e-4, atol=1e-4)


def test_k1_train_step_with_dims_matches_without(card):
    from acav100m_torch.ops import kmeans as tk

    dims, k, b = [352, 88, 40], 8, 256
    gen = torch.Generator().manual_seed(5)
    m, d = len(dims), max(dims)
    mask = (torch.arange(d)[None, :] < torch.tensor(dims)[:, None]).float()[:, None, :]
    batches = [(torch.randn((m, b, d), generator=gen) * mask).to(card) for _ in range(3)]
    states = []
    for known in (True, False):
        state = tk.init_state(dims, k, generator=torch.Generator().manual_seed(1), device=card)
        state.count = 10 * k
        if not known:
            state.dims = None
        for x in batches:
            state, mean = tk.train_step(state, x, 0.01)
        states.append((state, mean))
    (s1, m1), (s2, m2) = states
    assert s1.dims == tuple(dims) and s2.dims is None
    assert torch.equal(s1.centers, s2.centers) and torch.equal(s1.counts, s2.counts)
    assert torch.equal(m1, m2)


def _random_blocks(rnd, cin, stride, dtype=torch.float32, proj=False):
    """Three BN-folded blocks, 64 inner and 256 output channels; the weight
    matrices in ``dtype``, the biases float32. Block 0 has a projection
    where the shapes need one, or with ``proj``."""
    blocks = []
    for i in range(3):
        c_in = cin if i == 0 else 256
        blk = {"aw": rnd(c_in, 64, scale=c_in ** -0.5), "ab": rnd(64, scale=0.1),
               "bw": rnd(3, 3, 64, 64, scale=(9 * 64) ** -0.5), "bb": rnd(64, scale=0.1),
               "cw": rnd(64, 256, scale=0.125), "cb": rnd(256, scale=0.1)}
        if i == 0 and (cin != 256 or stride != 1 or proj):
            blk.update(pw=rnd(c_in, 256, scale=c_in ** -0.5), pb=rnd(256, scale=0.1))
        blocks.append({k: v.to(dtype) if v.dim() > 1 else v for k, v in blk.items()})
    return blocks


@pytest.mark.parametrize("n,hw,stride,cin,big", [
    (2, 8, 1, 80, 1.0), (2, 6, 2, 80, 1.0), (3, 13, 1, 256, 1.0),
    (2, 18, 1, 80, 1.0),  # the path's width; 18 is cut by neither tile side
    (2, 16, 1, 80, 1e3),  # a few input channels near 1e3: one TF32 product misses
])
def test_k2_matches_plain(card, n, hw, stride, cin, big):
    gen = torch.Generator().manual_seed(hw)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    blocks = _random_blocks(rnd, cin, stride)
    x = rnd(n, hw, hw, cin)
    x[..., :4] *= big
    with tracing.enabled():
        out = fused_stage(x, blocks, stride)
    assert tracing.counters()["k2_fp32.launches"] == 3
    ref = fused_stage_ref(x, blocks, stride)
    assert out.shape == ref.shape
    # 3xTF32 keeps the products near fp32; one TF32 product would miss this
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("n,hw,stride,cin,proj", [
    (32, 64, 1, 80, True),    # the main path: s2 slow at 256^2 input, 4 clips of 8 frames
    (33, 64, 1, 80, True),    # 528 tiles of 16 x 16: 4 a CTA on 132 SMs, a frame past 32
    (2, 24, 1, 256, True),    # Cin 256 with the projection in block 0
    (4, 10, 2, 80, True),     # stride 2 on a frame neither tile side cuts
    (3, 13, 1, 256, False),   # identity shortcut in block 0, ragged edges
])
def test_k2_float32_path_shapes_match_plain(card, n, hw, stride, cin, proj):
    """The float32 form at the main path's shape and around it, on weights
    packed once (as the model caches them) and packed by the wrapper."""
    gen = torch.Generator().manual_seed(n + hw + cin)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    blocks = _random_blocks(rnd, cin, stride, proj=proj)
    packed = [pack_block_f32(blk) for blk in blocks]
    x = rnd(n, hw, hw, cin)
    with tracing.enabled():
        out = fused_stage(x, blocks, stride, packed)
        again = fused_stage(x, blocks, stride)
    assert tracing.counters()["k2_fp32.launches"] == 6
    ref = fused_stage_ref(x, blocks, stride)
    assert out.shape == ref.shape and torch.equal(out, again)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("n,hw,stride,cin,inner,cout", [
    (2, 16, 1, 80, 32, 256),    # 32 inner channels
    (3, 10, 2, 88, 32, 64),     # 32 inner channels at stride 2, Cin padded to 96, one pass
    (2, 12, 1, 512, 64, 512),   # four passes of product c, the identity shortcut
    (2, 8, 1, 96, 64, 768),     # six passes with the projection
    (2, 12, 2, 64, 64, 384),    # stride 2, three passes: the second warpgroup idles in one
])
def test_k2_float32_other_widths_match_plain(card, n, hw, stride, cin, inner, cout):
    gen = torch.Generator().manual_seed(cin + inner + cout + stride)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    blocks = []
    for i in range(2):
        c_in = cin if i == 0 else cout
        blk = {"aw": rnd(c_in, inner, scale=c_in ** -0.5), "ab": rnd(inner, scale=0.1),
               "bw": rnd(3, 3, inner, inner, scale=(9 * inner) ** -0.5),
               "bb": rnd(inner, scale=0.1), "cw": rnd(inner, cout, scale=inner ** -0.5),
               "cb": rnd(cout, scale=0.1)}
        if i == 0 and (cin != cout or stride != 1):
            blk.update(pw=rnd(c_in, cout, scale=c_in ** -0.5), pb=rnd(cout, scale=0.1))
        blocks.append(blk)
    x = rnd(n, hw, hw, cin)
    with tracing.enabled():
        out = fused_stage(x, blocks, stride)
    assert tracing.counters()["k2_fp32.launches"] == 2
    ref = fused_stage_ref(x, blocks, stride)
    assert out.shape == ref.shape
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_k2_float32_refuses_what_it_cannot_take(card):
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    blocks = _random_blocks(rnd, 80, 1)
    x = rnd(2, 8, 8, 80)
    with tracing.enabled():
        with pytest.raises(ValueError):  # bf16 weight matrices for float32 frames
            fused_stage(x, [{k: v.to(torch.bfloat16) if v.dim() > 1 else v for k, v in blk.items()}
                            for blk in blocks])
        with pytest.raises(ValueError):  # input channels not a multiple of 4
            fused_stage(rnd(2, 8, 8, 78), _random_blocks(rnd, 78, 1))
        with pytest.raises(ValueError):  # a pack of other widths
            fused_stage(x, blocks, 1, [pack_block_f32(blocks[1])] * 3)
        with pytest.raises(ValueError):  # a pack of the bf16 form
            fused_stage(x, blocks, 1, [{k: v.to(torch.bfloat16) if k != "cb" else v
                                        for k, v in pack_block_f32(blk).items()} for blk in blocks])
        with pytest.raises(ValueError):  # a frame the stride does not divide
            fused_stage(rnd(2, 9, 9, 80), _random_blocks(rnd, 80, 2), 2)
    assert "k2_fp32.launches" not in tracing.counters()


@pytest.mark.parametrize("n,hw,stride,cin,proj", [
    (32, 64, 1, 80, True),    # the main path: s2 slow at 256^2 input, 4 clips of 8 frames
    (4, 10, 2, 80, True),     # stride 2, a frame neither tile side cuts
    (3, 13, 1, 256, False),   # identity shortcut in block 0, ragged edges
    (33, 64, 1, 80, True),    # 1056 tiles: not a multiple of the persistent grid
    (2, 24, 1, 256, True),    # Cin 256 with the projection in block 0 (pw streams)
    (2, 16, 1, 1024, True),   # Cin 1024 with the projection: aw streams too
])
def test_k2_bf16_matches_plain(card, n, hw, stride, cin, proj):
    gen = torch.Generator().manual_seed(hw + stride)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    blocks = _random_blocks(rnd, cin, stride, torch.bfloat16, proj)
    x = rnd(n, hw, hw, cin).to(torch.bfloat16)
    with tracing.enabled():
        out = fused_stage(x, blocks, stride)
        again = fused_stage_bf16(x, blocks, stride)
    c = tracing.counters()
    assert "k2_fp32.launches" not in c and c["k2_bf16.launches"] == 6
    ref = fused_stage_ref(x, blocks, stride)
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.equal(out, again)
    diff, scale = (out.float() - ref.float()).abs(), ref.float().abs().max()
    # 2 bf16 ulps of the output's max: a and b round after f32 sums taken
    # in another order than the plain version's
    assert diff.max() <= 1.6e-2 * scale
    assert diff.mean() <= 1e-3 * scale


@pytest.mark.parametrize("n,hw,stride,cin,inner,cout", [
    (2, 16, 1, 80, 32, 256),    # 32 inner channels
    (3, 10, 2, 88, 32, 64),     # 32 inner channels at stride 2, Cin padded to 96
    (2, 12, 1, 512, 64, 512),   # two passes of product c, the identity shortcut
    (2, 8, 1, 96, 64, 768),     # three passes with the projection
])
def test_k2_bf16_other_widths_match_plain(card, n, hw, stride, cin, inner, cout):
    gen = torch.Generator().manual_seed(cin + inner + cout)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    blocks = []
    for i in range(2):
        c_in = cin if i == 0 else cout
        blk = {"aw": rnd(c_in, inner, scale=c_in ** -0.5), "ab": rnd(inner, scale=0.1),
               "bw": rnd(3, 3, inner, inner, scale=(9 * inner) ** -0.5),
               "bb": rnd(inner, scale=0.1), "cw": rnd(inner, cout, scale=inner ** -0.5),
               "cb": rnd(cout, scale=0.1)}
        if i == 0 and (cin != cout or stride != 1):
            blk.update(pw=rnd(c_in, cout, scale=c_in ** -0.5), pb=rnd(cout, scale=0.1))
        blocks.append({k: v.to(torch.bfloat16) if v.dim() > 1 else v for k, v in blk.items()})
    x = rnd(n, hw, hw, cin).to(torch.bfloat16)
    with tracing.enabled():
        out = fused_stage_bf16(x, blocks, stride)
        again = fused_stage_bf16(x, blocks, stride)
    assert tracing.counters()["k2_bf16.launches"] == 4
    ref = fused_stage_ref(x, blocks, stride)
    assert out.shape == ref.shape and torch.equal(out, again)
    diff, scale = (out.float() - ref.float()).abs(), ref.float().abs().max()
    assert diff.max() <= 1.6e-2 * scale
    assert diff.mean() <= 1e-3 * scale


def test_k2_bf16_refuses_what_it_cannot_take(card):
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(card)

    x = rnd(2, 8, 8, 80).to(torch.bfloat16)
    with pytest.raises(ValueError):  # float32 weight matrices for bf16 frames
        fused_stage(x, _random_blocks(rnd, 80, 1))
    with pytest.raises(ValueError):  # input channels not a multiple of 8
        fused_stage(rnd(2, 8, 8, 84).to(torch.bfloat16),
                    _random_blocks(rnd, 84, 1, torch.bfloat16))


@pytest.mark.parametrize("n,ci,nq,nk", [
    (32, 256, 8192, 2048),  # res3 at 32 frames of 256^2, batch 32
    (32, 512, 2048, 512),   # res4
    (32, 256, 6272, 1568),  # res3 at 224^2 (PySlowFast's crop): Nk 1568 ends in half a stage
    (32, 512, 1568, 392),   # res4 at 224^2: Nq 1568 ends in a partial tile, Nk 392 likewise
    (3, 128, 2500, 578),    # Nq of 4 frames at 25^2, and Nk, padded to multiples of 8
    (3, 128, 384, 64),      # a partial wave, the smallest tile
])
def test_nonlocal_core_matches_its_twin(card, n, ci, nq, nk):
    gen = torch.Generator().manual_seed(ci + nk)
    theta = torch.randn((n, ci, nq), generator=gen).to(card, torch.bfloat16)
    phi = (torch.randn((n, ci, nk), generator=gen) + 0.5).to(card, torch.bfloat16)
    g = (torch.randn((n, ci, nk), generator=gen) + 0.3).to(card, torch.bfloat16)
    with tracing.enabled():
        y = nonlocal_core(theta, phi, g)
        again = nonlocal_core(theta, phi, g)
    assert tracing.counters()["nln_bf16.launches"] == 2
    torch.cuda.synchronize()
    ref = nonlocal_core_ref(theta, phi, g)
    assert y.dtype == torch.bfloat16 and torch.equal(y, again)
    # the kernel and the twin sum in other orders: a float32 sum on a bf16
    # rounding boundary of A^T or y lands on its other side, a step of y's
    # largest at most; nearly every element is bit-equal
    scale = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= 2 ** -7 * scale
    assert float((y == ref).float().mean()) >= 0.95


def test_nonlocal_core_refuses_what_it_cannot_take(card):
    theta = torch.zeros((2, 192, 200), device=card, dtype=torch.bfloat16)  # Ci not 128k
    phi = torch.zeros((2, 192, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        nonlocal_core(theta, phi, phi)
    # float32 runs the twin's float32 products on the card
    f32 = [torch.randn((2, 64, 40), device=card) for _ in range(3)]
    assert torch.equal(nonlocal_core(*f32), nonlocal_core_ref(*f32))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c,shape", [
    (8, (3, 5, 7, 9)),      # one bf16 vector a row; 945 rows
    (16, (2, 3, 5, 13)),    # 390 rows
    (64, (3, 4, 9, 11)),    # 1188 rows: ends in a partial block of vectors
    (2048, (2, 1, 3, 7)),   # 42 rows of 256 or 512 vectors
])
def test_conv_epilogue_matches_its_twin(card, dtype, residual, relu, c, shape):
    n, d, h, w = shape
    gen = torch.Generator().manual_seed(c + n * d)

    def cl(t):
        return t.to(card, dtype).contiguous(memory_format=torch.channels_last_3d)

    y0 = cl(torch.randn((n, c, d, h, w), generator=gen) * 3)
    bias = (torch.randn(c, generator=gen)).to(card)
    r = cl(torch.randn((n, c, d, h, w), generator=gen) * 2) if residual else None
    y, again = y0.clone(), y0.clone()
    with tracing.enabled():
        out = conv_epilogue(y, bias, r, relu)
        conv_epilogue(again, bias, r, relu)
    assert tracing.counters()["epilogue.launches"] == 2
    torch.cuda.synchronize()
    ref = conv_epilogue_ref(y0.clone(), bias, r, relu)
    assert out is y and y.dtype == dtype
    assert torch.equal(_bits(y), _bits(ref))
    assert torch.equal(_bits(y), _bits(again))
    if relu:
        assert float(y.float().min()) >= 0.0


def test_conv_epilogue_refuses_what_it_cannot_take(card):
    def cl(*shape, dtype=torch.float32):
        return torch.zeros(shape, device=card, dtype=dtype).contiguous(
            memory_format=torch.channels_last_3d)

    y, bias = cl(2, 16, 3, 4, 5), torch.zeros(16, device=card)
    with pytest.raises(ValueError):  # C not a multiple of 8
        conv_epilogue(cl(2, 12, 3, 4, 5), torch.zeros(12, device=card))
    with pytest.raises(ValueError):  # a dtype the kernel does not take
        conv_epilogue(cl(2, 16, 3, 4, 5, dtype=torch.float16), bias)
    with pytest.raises(ValueError):  # NCDHW memory: not channels-last
        conv_epilogue(torch.zeros((2, 16, 3, 4, 5), device=card), bias)
    with pytest.raises(ValueError):  # a strided slice of channels-last memory
        conv_epilogue(cl(2, 32, 3, 4, 5)[:, ::2], bias)
    with pytest.raises(ValueError):  # the residual of another shape
        conv_epilogue(y, bias, cl(2, 16, 3, 4, 6))
    with pytest.raises(ValueError):  # the residual in NCDHW memory
        conv_epilogue(y, bias, torch.zeros((2, 16, 3, 4, 5), device=card))
    with pytest.raises(ValueError):  # the residual of another dtype
        conv_epilogue(y, bias, cl(2, 16, 3, 4, 5, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # a bias of another dtype
        conv_epilogue(y, bias.to(torch.bfloat16))


def test_bf16_fast_stem_runs_tf32_products_of_the_bf16_values(card):
    """The fast stem's (5, 7, 7) conv on 3 bf16 channels runs as a TF32
    conv on the bf16 values (exact products, float32 sums, rounded once),
    with the caller's TF32 setting off: within one bf16 step of the float64
    conv of the same values, as the bf16 conv is, and the setting is left
    as it was."""
    from acav100m_torch.models import slowfast as tsf

    gen = torch.Generator().manual_seed(9)
    conv = tsf.ResNetBasicStem(3, 8, 5).conv
    x = torch.randn((2, 3, 8, 32, 32), generator=gen).to(card, torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    w = (torch.randn((8, 3, 5, 7, 7), generator=gen) * 0.1).to(card, torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    want = torch.nn.functional.conv3d(x.double(), w.double(), None, conv.stride, conv.padding)
    assert not torch.backends.cudnn.allow_tf32  # the module's fixture
    got = tsf._conv(conv.to(card), w, x)
    assert not torch.backends.cudnn.allow_tf32
    assert got.dtype == torch.bfloat16 and got.permute(0, 2, 3, 4, 1).is_contiguous()
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 2 ** -7 * scale


@pytest.mark.parametrize("name,dtype", [("layer_slowfast", torch.float32),
                                        ("layer_slowfast", torch.bfloat16),
                                        ("layer_slowfast_nln", torch.bfloat16)])
def test_folded_forward_on_card_matches_cpu(card, name, dtype):
    """The eval-mode forward (BN folded, channels-last, the epilogue) on the
    card against the same model on the CPU (the twin): 93 epilogue launches
    a forward, 2 stems, 4 fuses and 3 in each of the 29 canonical blocks
    (K2 runs the slow ``s2``)."""
    from acav100m_torch.models import get_model

    torch.manual_seed(5)
    model = get_model(name)(dtype=dtype)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():  # BN statistics and non-zero scales, so every fold matters
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm3d):
                c = mod.num_features
                mod.weight.copy_(torch.rand(c, generator=gen) * 0.2 + 0.1)
                mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    frames = torch.randint(0, 255, (2, 32, 64, 64, 3), generator=gen, dtype=torch.uint8)
    with torch.inference_mode():
        want = model(frames)
    model.to(card)
    with torch.inference_mode(), tracing.enabled():
        got = model(frames.to(card))
        counts = tracing.counters()
    assert counts["epilogue.launches"] == 93
    k2 = "k2_fp32.launches" if dtype == torch.float32 else "k2_bf16.launches"
    assert counts[k2] == 3
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        err = float((g.float().cpu() - w.float()).abs().max())
        # float32 without TF32 sums in other orders; bf16 rounds a step apart
        assert err <= (1e-4 if dtype == torch.float32 else 5e-2) * scale, (err, scale)


def _batch_mi_launch(state):
    """One launch on a copy of ``state``: (indices, scores, cache, stats)."""
    cache, stats, pairs_all, ids, valid, k, weights = state
    cache = {key: t.clone() for key, t in cache.items()}
    stats = {key: t.clone() for key, t in stats.items()}
    out_host = torch.empty(2 * k, dtype=torch.int32, pin_memory=True)
    mi.batch_mi_step(cache, stats, pairs_all, ids, valid, k, weights, out_host=out_host)
    torch.cuda.synchronize()
    out = out_host.numpy()
    return out[:k].tolist(), out[k:].view(np.float32), cache, stats


@pytest.mark.parametrize("state", bm.STATES)
def test_batch_mi_step_matches_its_twin(card, state):
    st = bm.state(state, card)
    cache, stats, pairs_all, ids, valid, k, weights = st
    with tracing.enabled():
        idx, scores, got_cache, got_stats = _batch_mi_launch(st)
    assert tracing.counters()["batch_mi.launches"] == 1
    ids_t = torch.as_tensor(ids, device=card)
    want_idx, _, want_cache, want_stats = mi.batch_mi_step_ref(cache, stats, pairs_all, ids_t,
                                                               valid, k, bm.C, weights)
    all_scores = mi.score_candidates_mem(cache, stats, pairs_all[ids_t], bm.C, weights)
    all_scores = torch.where(torch.arange(len(ids), device=card) < valid, all_scores,
                             torch.full_like(all_scores, -float("inf"))).cpu()
    # the kernel's scores of its picks against the twin's scores of the same
    # candidates: the mean over pairs is summed in another order
    finite = torch.isfinite(all_scores)
    scale = float(all_scores[finite].abs().max())
    twin = all_scores[idx].numpy()
    real = np.isfinite(twin)
    assert np.array_equal(np.isfinite(scores), real)
    assert np.abs(scores[real] - twin[real]).max() <= 1e-6 * scale
    # the same picks wherever no two of the twin's first k+1 lie within 1e-5
    # (exact ties, such as the pads' -inf, go to the lowest index in both)
    top = torch.sort(all_scores, descending=True, stable=True)[0][:k + 1]
    gaps = (top[:-1] - top[1:]).abs()
    assert not bool(((gaps > 0) & (gaps <= 1e-5)).any())
    assert idx == want_idx.tolist()
    for key in ("N", "a", "b", "n"):  # exact integer counts: bit for bit
        assert torch.equal(got_cache[key], want_cache[key]), key
    for key in ("NlogN", "aloga", "blogb"):
        torch.testing.assert_close(got_stats[key], want_stats[key], rtol=1e-6, atol=0)


def test_batch_mi_step_two_launches_give_the_same_bytes(card):
    st = bm.state("after_200", card)
    first, second = _batch_mi_launch(st), _batch_mi_launch(st)
    assert first[0] == second[0] and first[1].tobytes() == second[1].tobytes()
    for a, b in zip(first[2:], second[2:]):
        assert all(torch.equal(a[key], b[key]) for key in a)


def test_batch_mi_run_greedy_at_the_cell_shape(card):
    """A whole ``run_greedy`` at ``select.fp32.batch_mi``'s shapes (V 32000,
    45 pairs, K=32, B 20, k 4, a subset of 6400), replayed in float64 along
    its own picks."""
    from benchmark.reference import batch_mi

    v, subset, seed = 32000, 6400, 5
    a = bm.assignments(seed, v=v)
    rng = np.random.RandomState(seed)
    order = np.arange(v)
    rng.shuffle(order)
    sel = mi.BatchGreedySelector(a, bm.COMBOS, bm.C, batch_size=bm.B, selection_size=bm.K,
                                 rng=rng, device=card)
    assert sel.fused
    with tracing.enabled():
        picks, gains, _, _ = sel.run_greedy(subset, [int(order[0])])
    counts = tracing.counters()
    assert counts["batch_mi.launches"] == counts["select.iterations"] == subset // bm.K
    assert counts["select.host_reads"] == counts["select.iterations"]
    res = batch_mi.replay(a, bm.COMBOS, bm.C, subset, bm.B, bm.K, seed, picks, gains)
    assert len(picks) == subset and res["foreign"] == 0
    assert res["pick_gap"] <= 1e-4 and res["gain_err"] <= 1e-2


@pytest.mark.parametrize("keep_unselected", [True, False])
def test_batch_greedy_matches_jax_on_card(card, keep_unselected):
    """``test_torch_mi.py::test_batch_greedy_matches_jax`` in float32 on the
    card, through the fused step: the JAX package's run on the same pool,
    seed and start (recorded on the CPU in ``tests/data/batch_greedy_jax.npz``,
    since the card's machine has no JAX) gives the same picks, gains within
    1e-5 and the same final counts. Duplicated rows tie exactly in any order
    of summation, so those ties still go to the lowest index."""
    p = bm.PARITY
    record = np.load(bm.JAX_RECORD)
    want = {name: record[bm.record_key(keep_unselected, name)]
            for name in ("picks", "gains", "N", "a", "b", "n")}
    combos = get_cluster_pairing([(str(i), "x") for i in range(p["d"])], "combination")
    sel = mi.BatchGreedySelector(bm.parity_assignments(), combos, ncentroids=p["c"],
                                 batch_size=p["batch_size"], selection_size=p["selection_size"],
                                 keep_unselected=keep_unselected,
                                 rng=np.random.RandomState(p["rng_seed"]), device=card)
    assert sel.fused
    with tracing.enabled():
        picks, gains, _, _ = sel.run_greedy(p["subset"], p["start"])
    counts = tracing.counters()
    assert counts["batch_mi.launches"] == counts["select.iterations"] > 0
    assert picks == want["picks"].tolist()
    k = sel.k
    ties = [i for i in range(len(gains) - 1) if i % k != k - 1 and gains[i] == gains[i + 1]]
    assert ties  # some rounds select exactly tied candidates
    np.testing.assert_allclose(gains, want["gains"], rtol=1e-5, atol=1e-5)
    for key in ("N", "a", "b", "n"):  # exact integer counts
        np.testing.assert_array_equal(sel.cache[key].cpu().numpy(), want[key])


def test_batch_mi_step_refuses_what_it_cannot_take(card):
    cache, stats, pairs_all, ids, valid, k, _ = bm.state("after_200", card)
    many = np.resize(ids, mi.BATCH_MI_MAX_B + 1)
    for args in ((many, valid, k), (ids, valid, len(ids) + 1), (ids, 0, k)):
        with tracing.enabled(), pytest.raises(ValueError):
            mi.batch_mi_step(cache, stats, pairs_all, *args)
        assert not tracing.counters().get("batch_mi.launches")
    with pytest.raises(ValueError):  # float64 takes the eager chain, never the kernel
        mi.batch_mi_step({key: t.double() for key, t in cache.items()}, stats, pairs_all, ids,
                         valid, k)
    with pytest.raises(ValueError):
        mi.BatchGreedySelector(np.zeros((600, bm.D), np.int64), bm.COMBOS, bm.C,
                               batch_size=mi.BATCH_MI_MAX_B + 1, device=card)
    assert not mi.BatchGreedySelector(np.zeros((600, bm.D), np.int64), bm.COMBOS, bm.C,
                                      batch_size=mi.BATCH_MI_MAX_B + 1, device=card,
                                      dtype="float64").fused


@pytest.mark.parametrize("d", [16, 6, 1024])
def test_retrieval_sgd_kmeans_on_card_matches_cpu(card, d):
    """The retrieval frontend's k-means (M=1, K=10, batches of 64 and a tail
    of 44 over 20 epochs; D=6 zero-padded to 8 with K1 told 6): K1 on the
    card against the plain steps on the CPU, from the same seeded draws."""
    import numpy as np

    from acav100m_torch.retrieval import clustering as tc

    rng = np.random.RandomState(d)
    means = rng.randn(10, d) * 2.0
    x = tc.whiten((means[rng.randint(0, 10, 300)] + 0.3 * rng.randn(300, d))
                  .astype(np.float32))
    with tracing.enabled():
        on_card = tc.sgd_kmeans(x, 10, seed=3, device=card)
    # warmup is 100 samples: the first two steps of each run assign at random
    assert tracing.counters()["k1.launches"] == 20 * 5 - 2
    on_cpu = tc.sgd_kmeans(x, 10, seed=3, device="cpu")
    assert np.array_equal(on_card.assignments, on_cpu.assignments)
    np.testing.assert_allclose(on_card.centers, on_cpu.centers, rtol=1e-5, atol=1e-5)


FEED = ("frames", "audio", "valid_samples")


@pytest.fixture
def feed_clips(tmp_path):
    from acav100m_torch import cli

    cli.write_fixtures(tmp_path / "clips", num_shards=2, clips_per_shard=12, size=32)
    return tmp_path / "clips"


def _extract_rows(clips, out, **extra):
    """Rows of an extraction on the card (exact stand-in models, batches of
    2: 12 a shard) by filename, and the run's counters."""
    from acav100m_torch.pipeline import feature_extraction as fe
    from acav100m_torch.utils.io import load_pickle

    from .torch_fake_models import fake_models

    cfg = fe.get_config({"data.media.path": f"{clips}/shard-{{000000..000001}}.tar",
                         "data.output.path": str(out), "data.batch_size": 2,
                         "data.media.num_frames": 8, "log_period": 0, **extra})
    with tracing.enabled():
        saved = fe.run_extraction(cfg, models=fake_models("cuda"))
    rows = {r["filename"]: r for p in saved for r in load_pickle(p)}
    assert len(rows) == 24
    return rows, tracing.counters()


def _assert_same_taps(got, want):
    import numpy as np

    assert set(got) == set(want)
    for name, row in want.items():
        for side in ("audio_features", "video_features"):
            for g, w in zip(got[name][side], row[side]):
                for layer, arr in w["array"].items():
                    np.testing.assert_array_equal(g["array"][layer], arr, err_msg=name)


def test_extraction_collates_into_pinned_memory_with_fresh_arrays_taps(card, feed_clips,
                                                                       tmp_path, monkeypatch):
    import numpy as np

    from acav100m_torch.pipeline import feature_extraction as fe

    pinned = []
    stage = fe._stage

    def spied(batch, device, stream):
        pinned.append(all(fe._pinned(batch[k]) is not None for k in FEED))
        return stage(batch, device, stream)

    monkeypatch.setattr(fe, "_stage", spied)
    rows, counts = _extract_rows(feed_clips, tmp_path / "pinned")
    assert pinned == [True] * 12
    assert counts["extract.pinned_batches"] == counts["extract.batches"] == 12
    pinned.clear()
    monkeypatch.setattr(fe, "_pinned_empty", np.empty)  # fresh pageable arrays
    fresh, counts = _extract_rows(feed_clips, tmp_path / "fresh")
    assert pinned == [False] * 12 and "extract.pinned_batches" not in counts
    _assert_same_taps(rows, fresh)


def test_delayed_copies_never_read_a_rewritten_batch(card, feed_clips, tmp_path, monkeypatch):
    """Each copy to the card queued behind a sleep on the side stream, with
    more batches than are in flight: a pinned block taken again before its
    copy ran would give some row another clip's taps."""
    from acav100m_torch.pipeline import feature_extraction as fe

    want, _ = _extract_rows(feed_clips, tmp_path / "serial",
                            **{"computation.device_prefetch": 0})
    stage = fe._stage

    def delayed(batch, device, stream):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(50_000_000)
        return stage(batch, device, stream)

    monkeypatch.setattr(fe, "_stage", delayed)
    got, counts = _extract_rows(feed_clips, tmp_path / "delayed",
                                **{"computation.device_prefetch": 4})
    assert counts["extract.pinned_batches"] == counts["extract.batches"] == 12
    _assert_same_taps(got, want)
