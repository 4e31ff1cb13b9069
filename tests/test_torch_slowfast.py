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


def _fold_caches(model):
    """{module name: its fold cache} of every ``FoldCache`` module."""
    return {name: mod._folded_cache for name, mod in model.named_modules()
            if isinstance(mod, tsf.FoldCache)}


def test_folded_weights_follow_loaded_weights(variables):
    """Eval mode folds BN once (K2's stage, the stems, the fuse convs and
    every canonical block); loading weights, moving the model or a mode
    change drops every folded copy, so the folded forward keeps agreeing
    with the weights it was handed."""
    frames = torch.from_numpy(
        np.random.RandomState(4).randint(0, 255, (1, 8, 16, 16, 3)).astype(np.uint8))
    fused, canon = tsf.LayerSlowFast(pallas_stages=True), tsf.LayerSlowFast(pallas_stages=False)
    with torch.inference_mode():
        fused(frames)  # folds the constructor's weights
    assert fused.s2._folded_cache is not None
    built = {k for k, v in _fold_caches(fused).items() if v is not None}
    # 2 stems, 4 fuses, K2's stage s2 and the 29 blocks it leaves
    assert len(built) == 2 + 4 + 1 + 29 and "s2.pathway0_res0" not in built
    sd = tsf.state_dict_from_flax(variables)
    before = fused.s3.pathway1_res0._folded_cache[torch.float32]["a"][0].clone()
    fused.load_state_dict(sd)
    canon.load_state_dict(sd)
    assert all(v is None for v in _fold_caches(fused).values())
    with torch.inference_mode():
        got, want = fused(frames), canon(frames)
    assert fused.s2._folded_cache is not None
    assert not torch.equal(fused.s3.pathway1_res0._folded_cache[torch.float32]["a"][0], before)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    fused.to(torch.float32)
    assert all(v is None for v in _fold_caches(fused).values())
    with torch.inference_mode():
        again = fused(frames)
    assert {k for k, v in _fold_caches(fused).items() if v is not None} == built
    for g, w in zip(again, got):
        assert torch.equal(g, w)
    fused.train()
    assert all(v is None for v in _fold_caches(fused).values())


def test_eval_forward_is_folded_and_channels_last(variables):
    """In eval mode every stem, fuse and canonical block hands on NDHWC
    memory (``channels_last_3d``), from folded weights in that layout and a
    float32 bias; the fast pathway enters as a view of the frames."""
    model = tsf.LayerSlowFast()
    model.load_state_dict(tsf.state_dict_from_flax(variables))
    layouts = {}

    def hook(name):
        def record(mod, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            layouts[name] = all(o.permute(0, 2, 3, 4, 1).is_contiguous() for o in outs)
        return record

    for name, mod in model.named_modules():
        if isinstance(mod, (tsf.ResBlock, tsf.ResNetBasicStem, tsf.FuseFastToSlow,
                            tsf.ResStage)):
            mod.register_forward_hook(hook(name))
    seen = {}
    stem = model.s1.pathway1_stem
    stem.register_forward_pre_hook(lambda mod, args: seen.update(fast=args[0]))
    frames = torch.from_numpy(
        np.random.RandomState(5).randint(0, 255, (2, 8, 16, 16, 3)).astype(np.uint8))
    with torch.inference_mode():
        model(frames)
    ran = {k for k in layouts if not k.startswith("s2.pathway0_res")}  # K2 runs those
    assert ran and all(layouts[k] for k in ran), layouts
    assert seen["fast"].permute(0, 2, 3, 4, 1).is_contiguous()
    w, b = stem._folded_cache[torch.float32]
    assert w.permute(0, 2, 3, 4, 1).is_contiguous() and b.dtype == torch.float32
    blk = model.s3.pathway0_res0._folded_cache[torch.float32]
    assert set(blk) == {"a", "b", "c", "branch1"}
    mul, add = tbk.fold_bn(*(getattr(model.s3.pathway0_res0.branch1_bn, k) for k in (
        "weight", "bias", "running_mean", "running_var")))
    _, c_add = tsf.fold_conv(model.s3.pathway0_res0.branch2.c, model.s3.pathway0_res0.branch2.c_bn)
    assert torch.equal(blk["c"][1], c_add + add)  # the projection's bias in c's


def test_training_mode_runs_the_eager_graph(variables):
    """Training mode keeps BN, ReLU and the adds as their own ops: BN takes
    the batch's statistics and updates its running ones, gradients reach
    every BN, nothing is folded and no epilogue runs."""
    model = tsf.LayerSlowFast(pallas_stages=False)
    model.load_state_dict(tsf.state_dict_from_flax(variables))
    frames = torch.from_numpy(
        np.random.RandomState(6).randint(0, 255, (2, 8, 16, 16, 3)).astype(np.uint8))
    with torch.inference_mode():
        evaluated = model(frames)
    model.train()
    bn = model.s3.pathway0_res1.branch2.b_bn
    running = bn.running_mean.clone()
    calls = []
    epilogue = tsf.conv_epilogue
    tsf.conv_epilogue = lambda *args, **kw: calls.append(args) or epilogue(*args, **kw)
    try:
        taps = model(frames)
    finally:
        tsf.conv_epilogue = epilogue
    assert calls == [] and all(v is None for v in _fold_caches(model).values())
    assert not torch.equal(bn.running_mean, running)
    assert all(not torch.allclose(t, e) for t, e in zip(taps, evaluated))
    sum(t.sum() for t in taps).backward()
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            assert mod.weight.grad is not None


@pytest.mark.parametrize("make,shapes", [
    (lambda: tsf.ResNetBasicStem(3, 8, 5), [(1, 3, 4, 16, 16)]),
    (lambda: tsf.FuseFastToSlow(8), [(1, 64, 2, 8, 8), (1, 8, 8, 8, 8)]),
    (lambda: tsf.ResBlock(16, 32, 8, 3, 2), [(1, 16, 4, 8, 8)]),
])
def test_eval_forward_with_autograd_raises(make, shapes):
    """The eval graph's folded weights are made without autograd: with
    autograd on and parameters that require grad, an eval-mode forward
    raises instead of leaving them without gradients; under ``no_grad``
    it runs, and in training mode the gradients reach the conv."""
    mod = make().eval()
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(s, generator=gen).contiguous(memory_format=torch.channels_last_3d)
          for s in shapes]
    with pytest.raises(RuntimeError, match="no gradients"):
        mod(*xs)
    with torch.no_grad():
        mod(*xs)
    mod.requires_grad_(False)
    mod(*xs)  # frozen parameters: nothing to lose
    mod.requires_grad_(True).train()
    out = mod(*xs)
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))).backward()
    conv = next(m for m in mod.modules() if isinstance(m, torch.nn.Conv3d))
    assert conv.weight.grad is not None


def test_canonical_and_kernel_routes_share_parameters():
    a, b = tsf.LayerSlowFast(pallas_stages=True), tsf.LayerSlowFast(pallas_stages=False)
    assert list(a.state_dict()) == list(b.state_dict())
    assert "s2.pathway0_res0.branch1_bn.running_var" in a.state_dict()
