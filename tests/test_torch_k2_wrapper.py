"""What kernel K2's wrapper decides on the host, checked on the CPU: the
shapes and dtypes it hands to the kernel's two forms (float32, bfloat16) or
refuses, the plain version it runs for CPU tensors, and the ablation
variants of the kernel sources. The kernels themselves run only on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from acav100m_torch import ablate_k2, tracing
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
    with tracing.enabled():
        out = tbk.fused_stage(x, blocks, stride=2)
        assert tracing.counters() == {}
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


def test_bf16_timeline_stamps_every_phase_of_the_bf16_source():
    src = ablate_k2.variant_source(ablate_k2.TIMELINE_BF16, ablate_k2.SRC_BF16)
    for k in range(len(ablate_k2.TIMELINE_PHASES) + 1):
        assert src.count(f"STAMP({k})") == 1
    assert 'extern "C" int read_timeline(' in src
    assert 'extern "C" int bottleneck_block_bf16(' in src


def test_f32_timeline_stamps_every_phase_of_the_float32_source():
    src = ablate_k2.variant_source(ablate_k2.TIMELINE_F32, ablate_k2.SRC)
    for k in range(len(ablate_k2.TIMELINE_PHASES_F32) + 1):
        assert src.count(f"STAMP({k})") == 1
    assert 'extern "C" int read_timeline(' in src
    assert 'extern "C" int bottleneck_block(' in src


def test_ablation_parent_form_is_read_from_its_entry_point(tmp_path):
    f32, bf16 = tmp_path / "f32.cu", tmp_path / "bf16.cu"
    f32.write_text(ablate_k2.SRC.read_text())
    bf16.write_text(ablate_k2.SRC_BF16.read_text())
    assert ablate_k2.parent_form(f32) == "float32"
    assert ablate_k2.parent_form(bf16) == "bf16"
    # both forms' launchers take their packs now; the mma.sync float32
    # launcher took the raw weights and the output tile
    assert not ablate_k2.parent_takes_tile(f32) and not ablate_k2.parent_takes_tile(bf16)
    old = tmp_path / "old.cu"
    old.write_text('extern "C" int bottleneck_block(\n    const void* pw, const void* pb, '
                   'int Ci, int Cout, int s, int TH, int TW,\n    void* out, void* stream) {\n}\n')
    assert ablate_k2.parent_takes_tile(old)


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
    # bf16 Cout past the 768 whose cw the kernel keeps resident in shared memory
    (lambda: _block(80, 64, 800, True, torch.bfloat16), 80),
])
def test_check_block_refuses_other_dtype_mixes(make, cin):
    with pytest.raises(ValueError):
        tbk._check_block(make(), cin, torch.device("cpu"))


def test_bf16_cout_limit_is_768_and_cpu_tensors_run_past_it():
    """K2's bf16 form takes Cout up to ``BF16_MAX_COUT`` = 768 (three
    passes of 256 columns) and refuses 800; CPU tensors take the plain
    version at any Cout, 800 included."""
    assert tbk.BF16_MAX_COUT == 768
    cpu = torch.device("cpu")
    assert tbk._check_block(_block(80, 64, 768, True, torch.bfloat16), 80, cpu) == torch.bfloat16
    with pytest.raises(ValueError, match="at most 768 output channels"):
        tbk._check_block(_block(80, 64, 800, True, torch.bfloat16), 80, cpu)
    assert tbk._check_block(_block(80, 64, 800, True), 80, cpu) == torch.float32
    blocks = [_block(80, 64, 800, True, torch.bfloat16)]
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 4, 80).astype(np.float32))
    x = x.to(torch.bfloat16)
    with tracing.enabled():
        out = tbk.fused_stage_bf16(x, blocks, stride=1)
        assert tracing.counters() == {}
    assert out.shape == (1, 4, 4, 800) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, tbk.fused_stage_ref(x, blocks, stride=1), rtol=0, atol=0)


def test_cpu_bf16_tensors_take_the_plain_version():
    blocks = [_block(80, 64, 256, True, torch.bfloat16),
              _block(256, 64, 256, False, torch.bfloat16)]
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 6, 6, 80).astype(np.float32))
    x = x.to(torch.bfloat16)
    with tracing.enabled():
        out = tbk.fused_stage(x, blocks, stride=2)
        direct = tbk.fused_stage_bf16(x, blocks, stride=2)
        assert tracing.counters() == {}
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


def _unpack_k(p, k):
    """The inverse of ``bottleneck_kernel._pack_k``: (kp/8, N, 8) -> (k, N)."""
    return p.transpose(1, 2).reshape(-1, p.shape[1])[:k]


def _unpack_block_bf16(packed, cin, cout):
    """The inverse of ``pack_block_bf16`` on the weight matrices."""
    inner = packed["aw"].shape[1]

    def passes(p, k):
        return torch.cat([_unpack_k(q, k) for q in p], dim=1)[:, :cout]

    out = {"aw": _unpack_k(packed["aw"], cin),
           "bw": torch.stack([_unpack_k(t, inner) for t in packed["bw"]]).reshape(
               3, 3, inner, inner),
           "cw": passes(packed["cw"], inner)}
    if "pw" in packed:
        out["pw"] = passes(packed["pw"], cin)
    return out


@pytest.mark.parametrize("cin,inner,cout,proj", [
    (80, 64, 256, True),    # s2 slow, block 0: no padding
    (256, 64, 256, False),  # s2 slow, blocks 1 and 2
    (88, 32, 64, True),     # Cin padded to 96, Cout to one pass of 256
    (96, 64, 544, True),    # three passes of 256 output columns
])
def test_bf16_pack_is_a_permutation_and_round_trips(cin, inner, cout, proj):
    blk = _block(cin, inner, cout, proj, torch.bfloat16)
    packed = tbk.pack_block_bf16(blk)
    back = _unpack_block_bf16(packed, cin, cout)
    assert set(back) == {k for k in blk if k.endswith("w")}
    for key, mat in back.items():
        assert mat.dtype == torch.bfloat16 and torch.equal(mat, blk[key])
        # the pack holds each value once, and zeros for the padding
        pad = packed[key].numel() - blk[key].numel()
        want = torch.cat([blk[key].flatten(), torch.zeros(pad, dtype=torch.bfloat16)])
        assert torch.equal(packed[key].flatten().float().sort().values,
                           want.float().sort().values)
    # element (k, n) of a K-major plane sits at [k // 8, n, k % 8]
    kp = -(-cin // 16) * 16
    assert packed["aw"].shape == (kp // 8, inner, 8)
    k, n = cin - 1, inner - 3
    assert packed["aw"][k // 8, n, k % 8] == blk["aw"][k, n]
    tap, k, n = 5, 9, inner - 1
    assert packed["bw"][tap, k // 8, n, k % 8] == blk["bw"][tap // 3, tap % 3, k, n]
    k, n = inner - 1, cout - 1
    assert packed["cw"][n // tbk.PASS, k // 8, n % tbk.PASS, k % 8] == blk["cw"][k, n]
    # cb carries the projection's bias, added in float32
    want_cb = blk["cb"] + blk["pb"] if proj else blk["cb"]
    assert packed["cb"].dtype == torch.float32 and torch.equal(packed["cb"], want_cb)


def test_bf16_pack_is_cached_with_the_folded_weights_and_dropped_with_them():
    from acav100m_torch.models import slowfast as tsf

    torch.manual_seed(0)
    model = tsf.LayerSlowFast(pallas_stages=True).eval()
    stage, bf16 = model.s2, torch.bfloat16
    packed = stage._packed(bf16)
    assert stage._packed(bf16) is packed
    assert ("packed", bf16) in stage._folded_cache and bf16 in stage._folded_cache
    for got, blk in zip(packed, stage._folded(bf16)):
        want = tbk.pack_block_bf16(blk)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)

    def repacked_after(change):
        change()
        assert stage._folded_cache is None
        fresh = stage._packed(bf16)
        assert fresh is not packed
        return fresh

    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["s2.pathway0_res0.branch2.a.weight"] *= 2
    fresh = repacked_after(lambda: model.load_state_dict(sd))
    assert not torch.equal(fresh[0]["aw"], packed[0]["aw"])
    packed = fresh
    packed = repacked_after(lambda: model.train().eval())
    packed = repacked_after(lambda: model.to(torch.float32))


def _unpack_block_f32(packed, cin, cout):
    """The inverse of ``pack_block_f32`` on the weight matrices: each
    matrix's big and small parts, unpacked and added."""
    inner = packed["aw"].shape[2]

    def passes(p, k):
        return torch.cat([_unpack_k(q, k) for q in p], dim=1)[:, :cout]

    out = {}
    for key, part in packed.items():
        if key == "cb":
            continue
        big, small = part
        if key == "aw":
            out[key] = (_unpack_k(big, cin), _unpack_k(small, cin))
        elif key == "bw":
            out[key] = tuple(torch.stack([_unpack_k(t, inner) for t in p]).reshape(
                3, 3, inner, inner) for p in (big, small))
        else:
            k = inner if key == "cw" else cin
            out[key] = (passes(big, k), passes(small, k))
    return out


@pytest.mark.parametrize("cin,inner,cout,proj", [
    (80, 64, 256, True),    # s2 slow, block 0: no padding
    (256, 64, 256, False),  # s2 slow, blocks 1 and 2
    (88, 32, 64, True),     # Cin padded to 96, Cout to one pass of 128
    (96, 64, 544, True),    # five passes of 128 output columns
])
def test_f32_pack_is_a_permutation_and_round_trips(cin, inner, cout, proj):
    blk = _block(cin, inner, cout, proj)
    packed = tbk.pack_block_f32(blk)
    back = _unpack_block_f32(packed, cin, cout)
    assert set(back) == {k for k in blk if k.endswith("w")}
    for key, (big, small) in back.items():
        # the pack holds the split of each value once, and zeros for the padding
        want_big, want_small = tbk.tf32_split(blk[key])
        assert torch.equal(big, want_big) and torch.equal(small, want_small)
        assert torch.equal(big + small, blk[key]) or (
            (big + small - blk[key]).abs() <= 2.0 ** -22 * blk[key].abs()).all()
        pad = packed[key][0].numel() - blk[key].numel()
        for part, want in ((packed[key][0], want_big), (packed[key][1], want_small)):
            full = torch.cat([want.flatten(), torch.zeros(pad)])
            assert torch.equal(part.flatten().sort().values, full.sort().values)
    # element (k, n) of a K-major plane of 4 sits at [part, k // 4, n, k % 4]
    kp = -(-cin // 16) * 16
    passes = -(-cout // tbk.PASS_F32)
    assert packed["aw"].shape == (2, kp // 4, inner, 4)
    assert packed["bw"].shape == (2, 9, inner // 4, inner, 4)
    assert packed["cw"].shape == (2, passes, inner // 4, tbk.PASS_F32, 4)
    k, n = cin - 1, inner - 3
    assert packed["aw"][0, k // 4, n, k % 4] == tbk.tf32_rna(blk["aw"][k, n])
    tap, k, n = 5, 9, inner - 1
    assert packed["bw"][0, tap, k // 4, n, k % 4] == tbk.tf32_rna(blk["bw"][tap // 3, tap % 3, k, n])
    k, n = inner - 1, cout - 1
    p, c = divmod(n, tbk.PASS_F32)
    big, small = tbk.tf32_split(blk["cw"][k, n])
    assert packed["cw"][0, p, k // 4, c, k % 4] == big
    assert packed["cw"][1, p, k // 4, c, k % 4] == small
    # cb carries the projection's bias, added in float32, zero past Cout
    want_cb = blk["cb"] + blk["pb"] if proj else blk["cb"]
    assert packed["cb"].dtype == torch.float32 and packed["cb"].shape == (passes * tbk.PASS_F32,)
    assert torch.equal(packed["cb"][:cout], want_cb)
    assert not packed["cb"][cout:].any()


def _ordinary():
    return np.random.RandomState(3).randn(4096).astype(np.float32)


def _ties():
    """Values halfway between two TF32 numbers: the 13 dropped bits are
    0x1000 exactly (round away from zero), and one below and above it."""
    rng = np.random.RandomState(4)
    bits = (rng.randint(0x3f000000, 0x41000000, 1024, dtype=np.int64) & ~0x1fff).astype(np.uint32)
    mags = np.concatenate([bits | 0x1000, bits | 0x0fff, bits | 0x1001])
    return np.concatenate([mags, mags | 0x80000000]).view(np.float32)


def _zeros():
    return np.array([0.0, -0.0, 0.0, 1e-30, -1e-30], dtype=np.float32)


def _near_1e3():
    return (1e3 + np.random.RandomState(5).randn(2048) * 10.0).astype(np.float32) * \
        np.where(np.arange(2048) % 2, 1, -1).astype(np.float32)


@pytest.mark.parametrize("make", [_ordinary, _ties, _zeros, _near_1e3],
                         ids=["ordinary", "ties", "zeros", "near_1e3"])
def test_tf32_split_rounds_as_cvt_rna_and_sums_back(make):
    """big is cvt.rna's TF32 (bits + 0x1000, low 13 bits cleared, on the
    magnitude), small the remainder rounded the same way, and big + small
    is the value to within 2^-22 of its magnitude."""
    v = make()

    def rna(a):
        return ((a.view(np.uint32).astype(np.uint64) + 0x1000) & 0xffffe000).astype(
            np.uint32).view(np.float32)

    big, small = tbk.tf32_split(torch.from_numpy(v))
    want_big = rna(v)
    want_small = rna((v - want_big).astype(np.float32))
    assert np.array_equal(big.numpy().view(np.uint32), want_big.view(np.uint32))
    assert np.array_equal(small.numpy().view(np.uint32), want_small.view(np.uint32))
    assert not (big.numpy().view(np.uint32) & 0x1fff).any()
    assert not (small.numpy().view(np.uint32) & 0x1fff).any()
    err = np.abs(big.numpy().astype(np.float64) + small.numpy() - v)
    assert (err <= 2.0 ** -22 * np.abs(v)).all()


def test_f32_pack_is_cached_with_the_folded_weights_and_dropped_with_them():
    from acav100m_torch.models import slowfast as tsf

    torch.manual_seed(0)
    model = tsf.LayerSlowFast(pallas_stages=True).eval()
    stage, f32 = model.s2, torch.float32
    packed = stage._packed(f32)
    assert stage._packed(f32) is packed
    assert ("packed", f32) in stage._folded_cache and f32 in stage._folded_cache
    for got, blk in zip(packed, stage._folded(f32)):
        want = tbk.pack_block_f32(blk)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)

    def repacked_after(change):
        change()
        assert stage._folded_cache is None
        fresh = stage._packed(f32)
        assert fresh is not packed
        return fresh

    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["s2.pathway0_res0.branch2.a.weight"] *= 2
    fresh = repacked_after(lambda: model.load_state_dict(sd))
    assert not torch.equal(fresh[0]["aw"], packed[0]["aw"])
    packed = fresh
    packed = repacked_after(lambda: model.train().eval())
    packed = repacked_after(lambda: model.to(torch.float32))


def test_packed_float32_weights_are_checked_against_the_block():
    blk = _block(80, 64, 256, True)
    cpu = torch.device("cpu")
    tbk._check_packed(tbk.pack_block_f32(blk), 80, 64, 256, cpu, torch.float32)
    with pytest.raises(ValueError):  # a pack of another block's widths
        tbk._check_packed(tbk.pack_block_f32(_block(256, 64, 256, False)), 80, 64, 256, cpu,
                          torch.float32)
    with pytest.raises(ValueError):  # the bf16 form's pack
        tbk._check_packed(tbk.pack_block_bf16(_block(80, 64, 256, True, torch.bfloat16)),
                          80, 64, 256, cpu, torch.float32)
