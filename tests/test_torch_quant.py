"""int8 extraction (``computation.quant=int8``) of the port against the JAX
package on the CPU: the quantization primitives element for element, the
int8 conv's int32 sums exactly, one quantized bottleneck of each kind, the
calibration maxima, the whole backbone's taps (canonical and
``fast_block=[4,4,4,4,4]``, whose blocked int8 kernels the port computes in
the canonical layout), and the checkpoint-loading contract.

Tolerances: the int8 sums are integers, so equal; a bottleneck fed the same
scales and an input on the scale's grid matches within 1e-5 relative (its
fp parts, BN and the dequantize, round in another order); calibration
maxima within 1e-5 relative (measured 6.5e-7 canonical, 7.2e-7 with
``fast_block``). Across the whole backbone an fp difference upstream of a
quantize (the stems, the fuse convs, BN) can move a value that lies within
rounding of a half step by one step; with the JAX package's scales carried
across, the float32 taps are held to a relative L2 of 1e-4 per tap
(measured here: at most 1.5e-7 canonical, 1.3e-7 with ``fast_block``: no
step moved). With each package's own calibration the scales differ by
their 7e-7, which moves a few steps: 5e-3 to 1.9e-2 on the canonical
model's last three taps here, whose means run over a few positions (16x16
frames), so ``tests/test_torch_quant_extract.py`` holds ``run_extraction``
to cosine, not to that 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.models import quant as jq
from acav100m_tpu.models import slowfast as jsf
from acav100m_torch import tracing
from acav100m_torch.models import quant as tq
from acav100m_torch.models import slowfast as tsf

from .torch_parity import random_variables

torch.set_num_threads(1)

FAST_BLOCK = (4, 4, 4, 4, 4)
TAP_REL_L2 = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_weight_qparams_and_quantize_act_equal_jax():
    rng = np.random.RandomState(0)
    k = (rng.randn(3, 3, 3, 16, 8) * rng.uniform(0.01, 2.0, 8)).astype(np.float32)
    k[..., 5] = 0.0  # a dead channel: the 1e-12 floor
    jqk, jsk = jq.weight_qparams(jnp.asarray(k))
    tqk, tsk = tq.weight_qparams(torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()))
    assert tqk.dtype == torch.int8 and tsk.dtype == torch.float32
    np.testing.assert_array_equal(tqk.numpy(), np.asarray(jqk).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    x = (rng.randn(4, 5, 6, 7) * 3).astype(np.float32)
    x.flat[:4] = [0.25, 0.75, -1.25, 1e6]  # halves round to even; saturation
    for scale in (np.float32(0.5), np.float32(0.037), np.float32(1e-12 / 127)):
        want = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.float32(scale)))
        got = tq.quantize_act(torch.from_numpy(x), torch.tensor(scale))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    bf = torch.from_numpy(x).bfloat16()
    want = np.asarray(jq.quantize_act(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16),
                                      jnp.float32(0.037)))
    np.testing.assert_array_equal(tq.quantize_act(bf, torch.tensor(np.float32(0.037))).numpy(),
                                  want)


# (cin, cout, kt, kh, kw, spatial stride): every conv geometry of the model
GEOMETRIES = [(16, 8, 1, 1, 1, 1), (16, 24, 1, 1, 1, 2), (16, 8, 3, 1, 1, 1),
              (8, 8, 1, 3, 3, 1), (8, 8, 1, 3, 3, 2)]


@pytest.mark.parametrize("cin,cout,kt,kh,kw,s", GEOMETRIES)
def test_int8_conv_equals_lax_int32_conv(cin, cout, kt, kh, kw, s):
    rng = np.random.RandomState(kt * 100 + kh * 10 + s)
    x = rng.randint(-127, 128, (2, 4, 9, 9, cin)).astype(np.int8)  # NDHWC
    w = rng.randint(-127, 128, (kt, kh, kw, cin, cout)).astype(np.int8)  # DHWIO
    pad = ((kt // 2, kt // 2), (kh // 2, kh // 2), (kw // 2, kw // 2))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(1, s, s), padding=pad,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), preferred_element_type=jnp.int32)
    xq = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    wmat = tq.weight_matrix(torch.from_numpy(w).permute(4, 3, 0, 1, 2))
    rows, shape = tq.conv3d_int8(xq, wmat, (kt, kh, kw), (1, s, s), (kt // 2, kh // 2, kw // 2))
    assert rows.dtype == torch.int32
    got = tq.rows_to_ncdhw(rows, shape).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_state(variables):
    """One flax bottleneck's variables -> the port's ResBlock state dict."""
    wrap = {c: {"s2_slow": {"block0": variables[c]}} for c in ("params", "batch_stats")}
    prefix = "s2.pathway0_res0."
    return {k[len(prefix):]: v for k, v in tsf.state_dict_from_flax(wrap).items()}


# (cin, cout, inner, kt, stride): projection and identity, strides 1 and 2, kt 1 and 3
BLOCKS = [(16, 32, 8, 1, 1), (16, 32, 8, 3, 2), (32, 32, 8, 3, 1), (32, 32, 8, 1, 1)]


@pytest.mark.parametrize("cin,cout,inner,kt,stride", BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_bottleneck_matches_jax(cin, cout, inner, kt, stride, dtype):
    rng = np.random.RandomState(cin + kt * 7 + stride)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    mod = jsf.QuantBottleneck(cout, inner, kt, stride, jdt)
    x0 = jnp.zeros((2, 4, 8, 8, cin))
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), x0, "int8"))
    v = random_variables({c: shapes[c] for c in ("params", "batch_stats")}, seed=cin + kt)
    scales = {"q_in": 0.02, "q_a": 0.05, "q_b": 0.04}
    v["quant"] = {site: {"amax": np.float32(127 * s)} for site, s in scales.items()}
    # an input on the scale's grid quantizes exactly in both
    s_in = np.float32(127 * scales["q_in"]) / np.float32(127.0)
    x = (rng.randint(-127, 128, (2, 4, 8, 8, cin)) * s_in).astype(np.float32)
    want = mod.apply(v, jnp.asarray(x).astype(jdt), "int8")
    blk = tsf.QuantResBlock(cin, cout, inner, kt, stride).eval()
    assert hasattr(blk, "branch1") == (cin != cout or stride != 1)
    blk.load_state_dict(_block_state(v))
    for site, s in scales.items():
        getattr(blk, site).fill_(float(np.float32(127 * s)))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous().to(tdt)
    with torch.inference_mode():
        got = blk(xt, "int8")
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:  # bf16 roundings of BN in another order: a bf16 ulp of the max
        assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(21).randint(0, 255, (2, 8, 16, 16, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def q_variables():
    shapes = jax.eval_shape(lambda: jsf.LayerSlowFast(quant="int8").init(
        jax.random.PRNGKey(0), num_frames=8, size=16))
    v = random_variables({c: shapes[c] for c in ("params", "batch_stats")}, seed=22)
    v["quant"] = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                        shapes["quant"])
    return v


def _port_model(variables, **kw):
    model = tsf.LayerSlowFast(**kw)
    model.load_state_dict(tsf.state_dict_from_flax(variables))
    return model


@pytest.fixture(scope="module", params=[(), FAST_BLOCK], ids=["canonical", "fast_block"])
def calibrated(request, q_variables, frames):
    fb = request.param or None
    jmodel = jsf.LayerSlowFast(quant="int8", fast_block=fb)
    jv = jmodel.calibrate(q_variables, jnp.asarray(frames))
    return fb, jv, jmodel.apply(jv, jnp.asarray(frames))


def test_calibration_maxima_match_jax(calibrated, q_variables, frames):
    fb, jv, _ = calibrated
    model = _port_model(q_variables, quant="int8", fast_block=fb)
    with torch.inference_mode():
        model.calibrate(torch.from_numpy(frames))
    got, want = model.quant_state_dict(), tsf.quant_state_from_flax(jv)
    assert list(got) == list(want) and len(got) == 3 * 2 * sum(tsf.STAGE_BLOCKS)
    for key, val in want.items():
        assert float(val) > 0, key
        np.testing.assert_allclose(float(got[key]), float(val), rtol=1e-5, err_msg=key)


def test_int8_taps_match_jax(calibrated, q_variables, frames):
    """JAX's calibrated ``quant`` collection carried across; with
    ``fast_block`` the JAX side runs ``QuantBlockedStage``."""
    fb, jv, want = calibrated
    model = _port_model(q_variables, quant="int8", fast_block=fb)
    model.load_quant_state_dict(tsf.quant_state_from_flax(jv))
    with tracing.enabled(), torch.inference_mode():
        got = model(torch.from_numpy(frames))
        assert "k2_fp32.launches" not in tracing.counters()
    assert [tuple(g.shape) for g in got] == [(2, d) for d in tsf.LAYER_DIMS]
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    assert max(errs) <= TAP_REL_L2, errs
    # and int8 is not fp: the last taps move off the fp model's
    fp = jsf.LayerSlowFast().apply(
        {c: q_variables[c] for c in ("params", "batch_stats")}, jnp.asarray(frames))
    assert _rel(got[-1].numpy(), fp[-1]) > 10 * TAP_REL_L2


def test_blocked_int8_weights_equal_canonical():
    """The claim behind computing ``fast_block`` in the canonical layout:
    the JAX package's blocked kernels quantize to the canonical scales and
    int8 weights, with exact zeros elsewhere."""
    rng = np.random.RandomState(3)
    for kt, kh in ((1, 1), (3, 1), (1, 3)):
        k = rng.randn(kt, kh, kh, 8, 16).astype(np.float32)
        qk, sk = jq.weight_qparams(jnp.asarray(k))
        for bt in (2, 4):
            wb, _ = jsf._blocked_temporal_kernel(jnp.asarray(k), bt)
            qb, sb = jq.weight_qparams(wb)
            np.testing.assert_array_equal(np.asarray(sb), np.tile(np.asarray(sk), bt))
            # every nonzero blocked entry is a canonical int8 weight of its channel
            qb = np.asarray(qb).reshape(-1, bt, 16)
            for u in range(bt):
                vals = np.unique(qb[:, u][qb[:, u] != 0])
                assert np.isin(vals, np.asarray(qk)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_calib_mode_reproduces_fp_taps(q_variables, frames, dtype):
    fp = _port_model(q_variables, pallas_stages=False, dtype=dtype)
    model = _port_model(q_variables, quant="int8", dtype=dtype)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        want, got = fp(x), model(x, quant_mode="calib")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(float(v) > 0 for v in model.quant_state_dict().values())


@pytest.mark.parametrize("build_inference", [False, True], ids=["built", "built_inference"])
@pytest.mark.parametrize("calib_inference", [False, True], ids=["calib", "calib_inference"])
def test_calibrate_under_any_inference_mode(q_variables, frames, build_inference,
                                            calib_inference):
    """A model built, loaded and moved under ``torch.inference_mode`` (its
    buffers then inference tensors), or outside it, calibrates inside or
    outside it to the same maxima, and its scales load back outside it."""
    want = _port_model(q_variables, quant="int8")
    with torch.no_grad():
        want.calibrate(torch.from_numpy(frames))
    with torch.inference_mode(build_inference):
        model = _port_model(q_variables, quant="int8").to("cpu").eval()
    with torch.inference_mode(calib_inference):
        model.calibrate(torch.from_numpy(frames))
    got = model.quant_state_dict()
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.quant_state_dict().items()}
    model.load_quant_state_dict(got)
    with torch.inference_mode():
        taps = model(torch.from_numpy(frames))
    assert all(torch.isfinite(t).all() for t in taps)


def test_uncalibrated_int8_is_finite(q_variables, frames):
    model = _port_model(q_variables, quant="int8")
    assert not any(float(v) for v in model.quant_state_dict().values())
    with torch.inference_mode():
        taps = model(torch.from_numpy(frames))
    assert all(torch.isfinite(t).all() for t in taps)


def test_quant_model_loads_checkpoints_and_keeps_state_dict(q_variables):
    sd = tsf.state_dict_from_flax(q_variables)
    fp, model = tsf.LayerSlowFast(), tsf.LayerSlowFast(quant="int8")
    assert list(model.state_dict()) == list(fp.state_dict())
    assert set(fp.state_dict()) == set(sd)
    model.load_state_dict(sd)  # strict: a checkpoint has no observer keys
    assert all(k.rsplit(".", 1)[-1] in tsf.QUANT_SITES for k in model.quant_state_dict())
    with pytest.raises(KeyError):
        model.load_quant_state_dict({})
    # the int8 weights are made once in eval mode and dropped on a load
    blk = model.s3.pathway0_res0
    first = blk.quantized_weights()
    assert blk.quantized_weights() is first
    assert first["a"][0].dtype == torch.int8 and first["a"][1].dtype == torch.float32
    model.load_state_dict(sd)
    assert blk.quantized_weights() is not first
    with pytest.raises(ValueError):
        tsf.LayerSlowFast(quant="int4")
    with pytest.raises(ValueError):
        fp.calibrate(torch.zeros(1, 8, 16, 16, 3, dtype=torch.uint8))
