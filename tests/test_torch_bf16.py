"""Stage 4 in the JAX package's headline configuration on the CPU:
``computation.dtype=bfloat16`` and ``computation.fast_block=[4,4,4,4,4]``.

bf16 rounds at other places in the two frameworks (XLA's convolutions and
flax's BN against PyTorch's), so the models' taps are held to accuracy, not
to bits: against the JAX float32 taps, the port's bf16 error is at most
twice JAX's own bf16 error plus 1e-3 of the tap's max, and the port stays
within 5e-2 of the tap's max of JAX's bf16 taps. Measured here (max
|difference| over max |float32 tap|, over the five taps): SlowFast, K2
route, port 4.1e-3 to 7.6e-3, JAX 4.1e-3 to 6.6e-3, port - JAX 0 to
4.9e-3; canonical route, port 3.6e-3 to 7.0e-3, JAX 3.5e-3 to 7.0e-3, port
- JAX 0 to 4.9e-3; VGGish, port 1.6e-3 to 4.1e-3, JAX 1.6e-3 to 6.4e-3,
port - JAX 2.3e-3 to 6.9e-3. Kernel K2's bf16 plain version rounds where
the JAX kernel rounds, so it is held to 1.6e-2 of the output's max (2 bf16
ulps: the intermediates are rounded after f32 sums taken in another order)
and its mean error to 1e-3; measured 0 to 5.6e-3 max, at most 1.0e-4
mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.models import slowfast as jsf
from acav100m_tpu.models import vggish as jv
from acav100m_tpu.ops.pallas import bottleneck_kernel as jbk
from acav100m_torch import cli as tcli
from acav100m_torch import tracing
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models import vggish as tv
from acav100m_torch.ops import bottleneck_kernel as tbk
from acav100m_torch.pipeline import feature_extraction as tfe
from acav100m_torch.utils.io import load_pickle

from .test_torch_slowfast import _random_stage
from .torch_parity import random_variables

torch.set_num_threads(1)

SPEC = "shard-{000000..000001}"
FAST_BLOCK = [4, 4, 4, 4, 4]


def _bf16_blocks(tblocks):
    """K2's bf16 form of float32 folded blocks: weight matrices in bf16,
    biases float32, as the JAX kernel's ``add_w`` casts them."""
    return [{k: v.to(torch.bfloat16) if v.dim() > 1 else v for k, v in blk.items()}
            for blk in tblocks]


@pytest.mark.parametrize("hw,stride", [(8, 1), (8, 2), (6, 1), (6, 2)])
def test_fused_stage_ref_bf16_matches_pallas(hw, stride):
    rng = np.random.RandomState(hw * 10 + stride + 7)
    jblocks, tblocks = _random_stage(rng)
    x = rng.randn(2, hw, hw, 80).astype(np.float32)
    want = jbk.fused_stage(jnp.asarray(x).astype(jnp.bfloat16), jblocks, stride=stride,
                           interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = tbk.fused_stage(torch.from_numpy(x).bfloat16(), _bf16_blocks(tblocks),
                          stride=stride)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (2, hw // stride, hw // stride, 256)
    diff = np.abs(got.float().numpy() - want)
    scale = np.abs(want).max()
    assert diff.max() <= 1.6e-2 * scale
    # most outputs agree to the bit: the roundings differ only near ties
    assert diff.mean() <= 1e-3 * scale


def _accuracy(got, want_bf16, want_f32):
    """Per tap: (port error, JAX bf16 error, |port - JAX bf16|), each the
    max over the float32 tap's max."""
    out = []
    for g, wb, wf in zip(got, want_bf16, want_f32):
        g, wb, wf = (np.asarray(a, np.float32) for a in (g, wb, wf))
        scale = np.abs(wf).max()
        out.append((np.abs(g - wf).max() / scale, np.abs(wb - wf).max() / scale,
                    np.abs(g - wb).max() / scale))
    return out


def _assert_as_accurate(errs):
    for port, jax_bf16, apart in errs:
        assert port <= 2 * jax_bf16 + 1e-3, errs
        assert apart <= 5e-2, errs


@pytest.fixture(scope="module")
def sf_variables():
    shapes = jax.eval_shape(
        lambda: jsf.LayerSlowFast().init(jax.random.PRNGKey(0), num_frames=8, size=16))
    return random_variables(shapes, seed=11)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(12).randint(0, 255, (2, 8, 16, 16, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def sf_float32_taps(sf_variables, frames):
    return jsf.LayerSlowFast().apply(sf_variables, jnp.asarray(frames))


@pytest.mark.parametrize("pallas_stages", [True, False])
def test_layer_slowfast_bf16_as_accurate_as_jax(sf_variables, frames, sf_float32_taps,
                                                pallas_stages):
    want = jsf.LayerSlowFast(dtype=jnp.bfloat16, pallas_stages=pallas_stages).apply(
        sf_variables, jnp.asarray(frames))
    model = tsf.LayerSlowFast(pallas_stages=pallas_stages, dtype=torch.bfloat16)
    model.load_state_dict(tsf.state_dict_from_flax(sf_variables))
    with tracing.enabled(), torch.inference_mode():
        got = model(torch.from_numpy(frames))
        launches = {k: v for k, v in tracing.counters().items() if k.endswith(".launches")}
    assert launches == {}
    assert [g.dtype for g in got] == [torch.bfloat16] * 5
    assert [tuple(g.shape) for g in got] == [(2, d) for d in tsf.LAYER_DIMS]
    if pallas_stages:  # K2's weights: matrices in bf16, biases float32
        folded = model.s2._folded_cache[torch.bfloat16]
        assert folded[0]["aw"].dtype == torch.bfloat16 and folded[0]["ab"].dtype == torch.float32
    # every other conv folded once, its weight cast to bf16, its bias float32
    for mod in (model.s1.pathway1_stem, model.s1_fuse, model.s3.pathway0_res0):
        folds = mod._folded_cache[torch.bfloat16]
        for w, b in folds.values() if isinstance(folds, dict) else [folds]:
            assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    _assert_as_accurate(_accuracy([g.float() for g in got], want, sf_float32_taps))


def test_layer_vggish_bf16_as_accurate_as_jax():
    shapes = jax.eval_shape(lambda: jv.LayerVggish().init(jax.random.PRNGKey(0), 32000))
    variables = random_variables(shapes, seed=13)
    rng = np.random.RandomState(14)
    audio = (rng.randn(2, 32000) * 0.3).astype(np.float32)
    audio[1, 15000:] = 0.0  # a zero-padded short clip
    valid = np.array([32000, 15000], np.int32)
    want_f32 = jv.LayerVggish().apply(variables, jnp.asarray(audio), jnp.asarray(valid))
    want = jv.LayerVggish(dtype=jnp.bfloat16).apply(variables, jnp.asarray(audio),
                                                    jnp.asarray(valid))
    model = tv.LayerVggish(dtype=torch.bfloat16)
    model.load_state_dict(tv.state_dict_from_flax(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(audio), torch.from_numpy(valid))
    # masked example means against a float32 mask are float32, as in JAX
    assert [g.dtype for g in got] == [torch.float32] * 5
    assert [np.asarray(w).dtype for w in want] == [np.float32] * 5
    _assert_as_accurate(_accuracy(got, want, want_f32))


def test_fast_block_matches_jax_blocked_path(sf_variables, frames):
    want = jsf.LayerSlowFast(fast_block=tuple(FAST_BLOCK)).apply(sf_variables,
                                                                 jnp.asarray(frames))
    model = tsf.LayerSlowFast(fast_block=FAST_BLOCK)
    model.load_state_dict(tsf.state_dict_from_flax(sf_variables))
    assert model.fast_block == (4, 4, 4, 4, 4)
    with torch.inference_mode():
        got = model(torch.from_numpy(frames))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("fast_block", [[4, 4, 4], [4, 4, 4, 4, -1], [4, 4, 4, 4, 2.5],
                                        "44444"])
def test_fast_block_refuses_what_jax_does_not_take(fast_block):
    with pytest.raises(ValueError):
        tsf.LayerSlowFast(fast_block=fast_block)


def test_bf16_build_keeps_float32_weights_and_writes_float32_pkls(tmp_path):
    tcli.main(["fixtures", str(tmp_path / "clips"), "--size=16"])
    base = {"data.media.path": f"{tmp_path}/clips/{SPEC}.tar", "data.batch_size": 4,
            "data.media.num_frames": 8, "computation.device": "cpu"}
    bf16 = {**base, "computation.dtype": "bfloat16", "computation.fast_block": FAST_BLOCK}
    f32_models = tfe.build_models(tfe.get_config(base))
    bf16_models = tfe.build_models(tfe.get_config(bf16))
    assert list(bf16_models) == list(f32_models)
    for name in f32_models:
        assert bf16_models[name].dtype == torch.bfloat16
        want, got = f32_models[name].state_dict(), bf16_models[name].state_dict()
        assert list(got) == list(want)
        for key, val in want.items():
            assert got[key].dtype == val.dtype and torch.equal(got[key], val), key
    out = tmp_path / "features"
    tfe.run_extraction(tfe.get_config({**bf16, "data.output.path": str(out)}),
                       models=bf16_models)
    rows = [r for p in sorted(out.glob("shard-*.pkl")) for r in load_pickle(p)]
    assert len(rows) == 8
    for row in rows:
        for side, dims in (("audio_features", tv.LAYER_DIMS),
                           ("video_features", tsf.LAYER_DIMS)):
            arrs = row[side][0]["array"]
            assert [arrs[f"layer_{i}"].shape for i in range(5)] == [(d,) for d in dims]
            for arr in arrs.values():
                assert arr.dtype == np.float32 and np.isfinite(arr).all()


def test_bf16_parameters_fold_in_float32():
    """A block whose parameters were cast to bf16 (``.to(torch.bfloat16)``)
    folds BN in float32 in eval mode: bf16 weights and float32 biases for
    the epilogue, and its output within bf16 rounding of its eager graph."""
    torch.manual_seed(4)
    blk = tsf.ResBlock(16, 32, 8, 3, 2)
    for mod in blk.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.weight.data = torch.rand(mod.num_features) + 0.5
            mod.bias.data = torch.randn(mod.num_features) * 0.1
            mod.running_mean.copy_(torch.randn(mod.num_features) * 0.1)
            mod.running_var.copy_(torch.rand(mod.num_features) + 0.5)
    blk = blk.to(torch.bfloat16).eval()
    x = torch.randn((2, 16, 4, 8, 8)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    with torch.no_grad():
        got, want = blk(x), blk._eager(x)
    folds = blk._folded_cache[torch.bfloat16]
    assert all(w.dtype == torch.bfloat16 and b.dtype == torch.float32
               for w, b in folds.values())
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert err <= 2 ** -6, err


@pytest.mark.parametrize("override", [{"computation.dtype": "float16"}])
def test_what_is_not_ported_still_raises(override):
    cfg = tfe.get_config({"computation.device": "cpu", **override})
    with pytest.raises(NotImplementedError):
        tfe.build_models(cfg)


def test_int8_builds_in_the_headline_configuration():
    """``computation.quant=int8`` with bf16 and ``fast_block``: the JAX
    package's int8 leg. Its weights are the float32 model's, no stage runs
    K2, and calibrated taps come out in bf16, finite; an unknown ``quant``
    string raises (the JAX package would run it as int8)."""
    base = {"computation.device": "cpu", "models": ["layer_slowfast"],
            "data.media.num_frames": 8, "computation.dtype": "bfloat16",
            "computation.fast_block": FAST_BLOCK}
    fp = tfe.build_models(tfe.get_config(base))["layer_slowfast"]
    model = tfe.build_models(tfe.get_config({**base, "computation.quant": "int8"}))[
        "layer_slowfast"]
    assert model.quant == "int8" and model.dtype == torch.bfloat16
    assert not any(getattr(model, f"s{k}").fused_slow for k in range(2, 6))
    want, got = fp.state_dict(), model.state_dict()
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    frames = torch.from_numpy(np.random.RandomState(15).randint(
        0, 255, (2, 8, 16, 16, 3)).astype(np.uint8))
    with tracing.enabled(), torch.inference_mode():
        model.calibrate(frames)
        taps = model(frames)
        launches = {k: v for k, v in tracing.counters().items() if k.endswith(".launches")}
    assert launches == {}
    assert all(float(v) > 0 for v in model.quant_state_dict().values())
    # the int8 blocks keep their own forward (BN unfolded, no epilogue);
    # the fp stems and fuse convs run folded, one epilogue pass each
    passes = []
    epilogue = tsf.conv_epilogue
    tsf.conv_epilogue = lambda y, *args: passes.append(y.shape) or epilogue(y, *args)
    try:
        with torch.inference_mode():
            again = model(frames)
    finally:
        tsf.conv_epilogue = epilogue
    assert len(passes) == 2 + 4
    assert all(torch.equal(a, t) for a, t in zip(again, taps))
    assert [t.dtype for t in taps] == [torch.bfloat16] * 5
    assert all(torch.isfinite(t).all() for t in taps)
    with pytest.raises(ValueError):
        tfe.build_models(tfe.get_config({**base, "computation.quant": "int4"}))
