"""Video side of stage 4: kernel K2's plain version against the JAX Pallas
stage (interpret mode), the port's ``LayerSlowFast`` taps against the JAX
package's with the same weights (K2 route and canonical route), and the
flax -> PySlowFast -> flax round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.models import slowfast as jsf
from acav100m_tpu.ops.pallas import bottleneck_kernel as jbk
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.ops import bottleneck_kernel as tbk

from .torch_parity import random_variables

torch.set_num_threads(1)


def _random_stage(rng, cin=80, inner=64, cout=256, n_blocks=3):
    """BN-folded blocks from random convs and random BN statistics; every
    gamma, each block's final branch2_c_bn one included, is non-zero (a
    zero final gamma would make the residual branch vanish)."""
    def bn(c):
        return (rng.uniform(0.5, 1.5, c), rng.randn(c) * 0.1, rng.randn(c) * 0.1,
                rng.uniform(0.5, 1.5, c))

    jblocks, tblocks = [], []
    for i in range(n_blocks):
        c_in = cin if i == 0 else cout
        convs = {"a": rng.randn(c_in, inner) / np.sqrt(c_in),
                 "b": rng.randn(3, 3, inner, inner) / np.sqrt(9 * inner),
                 "c": rng.randn(inner, cout) / np.sqrt(inner)}
        if i == 0:
            convs["p"] = rng.randn(c_in, cout) / np.sqrt(c_in)
        jb, tb = {}, {}
        for key, w in convs.items():
            stats = [s.astype(np.float32) for s in bn(w.shape[-1])]
            w = w.astype(np.float32)
            jmul, jadd = jbk.fold_bn(*map(jnp.asarray, stats))
            tmul, tadd = tbk.fold_bn(*map(torch.from_numpy, stats))
            np.testing.assert_allclose(tmul.numpy(), np.asarray(jmul), rtol=1e-6)
            jb[key + "w"], jb[key + "b"] = jnp.asarray(w) * jmul, jadd
            tb[key + "w"], tb[key + "b"] = torch.from_numpy(w) * tmul, tadd
        jblocks.append(jb)
        tblocks.append(tb)
    return jblocks, tblocks


@pytest.mark.parametrize("hw,stride", [(8, 1), (8, 2), (6, 1), (6, 2)])
def test_fused_stage_ref_matches_pallas(hw, stride):
    rng = np.random.RandomState(hw * 10 + stride)
    jblocks, tblocks = _random_stage(rng)
    x = rng.randn(2, hw, hw, 80).astype(np.float32)
    want = np.asarray(jbk.fused_stage(jnp.asarray(x), jblocks, stride=stride,
                                      interpret=True))
    got = tbk.fused_stage(torch.from_numpy(x), tblocks, stride=stride).numpy()
    assert got.shape == want.shape == (2, hw // stride, hw // stride, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(
        lambda: jsf.LayerSlowFast().init(jax.random.PRNGKey(0), num_frames=8, size=16))
    return random_variables(shapes, seed=1)


@pytest.mark.parametrize("pallas_stages", [True, False])
def test_layer_slowfast_taps_match(variables, pallas_stages):
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 255, (2, 8, 16, 16, 3)).astype(np.uint8)
    want = jsf.LayerSlowFast(pallas_stages=pallas_stages).apply(variables,
                                                                jnp.asarray(frames))
    model = tsf.LayerSlowFast(pallas_stages=pallas_stages)
    model.load_state_dict(tsf.state_dict_from_flax(variables))
    assert model.s2.fused_slow == pallas_stages
    assert not (model.s3.fused_slow or model.s4.fused_slow or model.s5.fused_slow)
    with torch.inference_mode():
        got = model(torch.from_numpy(frames))
    assert [g.shape for g in got] == [(2, d) for d in tsf.LAYER_DIMS]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_flax_round_trip_is_exact(variables):
    sd = tsf.state_dict_from_flax(variables)
    assert set(sd) == set(tsf.LayerSlowFast().state_dict())
    back = jsf.convert_pyslowfast_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_folded_weights_follow_loaded_weights(variables):
    """The K2 route folds BN once in eval mode; loading weights, moving the
    model or a mode change drops the folded copy, so the route keeps
    agreeing with the canonical one."""
    frames = torch.from_numpy(
        np.random.RandomState(4).randint(0, 255, (1, 8, 16, 16, 3)).astype(np.uint8))
    fused, canon = tsf.LayerSlowFast(pallas_stages=True), tsf.LayerSlowFast(pallas_stages=False)
    with torch.inference_mode():
        fused(frames)  # folds the constructor's weights
    assert fused.s2._folded_cache is not None
    sd = tsf.state_dict_from_flax(variables)
    fused.load_state_dict(sd)
    canon.load_state_dict(sd)
    assert fused.s2._folded_cache is None
    with torch.inference_mode():
        got, want = fused(frames), canon(frames)
    assert fused.s2._folded_cache is not None
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    fused.to(torch.float32)
    assert fused.s2._folded_cache is None
    with torch.inference_mode():
        fused(frames)
    fused.train()
    assert fused.s2._folded_cache is None


def test_canonical_and_kernel_routes_share_parameters():
    a, b = tsf.LayerSlowFast(pallas_stages=True), tsf.LayerSlowFast(pallas_stages=False)
    assert list(a.state_dict()) == list(b.state_dict())
    assert "s2.pathway0_res0.branch1_bn.running_var" in a.state_dict()
