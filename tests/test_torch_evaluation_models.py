"""The port's evaluation models (``acav100m_torch.evaluation.models``)
against the JAX package's on seeded weights: the backbones and projection
heads at narrow widths in eval and train mode, the InfoNCE loss, the flax
tree carried both ways, the reference's names, flax's default init, and
rematerialized blocks against plain ones.

Train-mode comparisons run in float64 on both sides: batch norm over the
few values a channel holds at these sizes (4 at ``s5`` for 2 clips of
4 x 32^2) turns float32 rounding of 1e-7 into output differences of about
1e-3, in either package against any other float32 implementation; in
float64 the two agree to about 1e-12."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.evaluation import models as jm
from acav100m_tpu.evaluation import train as jt
from acav100m_torch.evaluation import models as tm
from tests.torch_parity import random_variables

torch.set_num_threads(1)

OUT_TOL = 1e-5  # backbone and head outputs, relative to their largest magnitude
STATS_TOL = 1e-6  # running statistics after a train forward, relative


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def backbone(name, var):
    """A port backbone loaded with a JAX backbone's variables."""
    net = tm.VisualResNet3D(width=8) if name == "visual_conv" else tm.AudioResNet2D(width=4)
    net.load_state_dict(tm.backbone_state_dict_from_flax(
        {col: {name: tree} for col, tree in var.items()}, name))
    return net


def jax_backbone(name, train, dtype):
    if name == "visual_conv":
        return jm.VisualResNet3D(width=8, train=train, dtype=dtype)
    return jm.AudioResNet2D(width=4, train=train, dtype=dtype)


def backbone_input(name, dtype):
    rng = np.random.RandomState(7)
    if name == "visual_conv":
        return rng.randn(2, 4, 32, 32, 3).astype(dtype)  # (B, T, H, W, C)
    return rng.randn(2, 80, 128, 1).astype(dtype)


def to_nc(x: np.ndarray) -> torch.Tensor:
    """NDHWC / NHWC -> NCDHW / NCHW."""
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


@functools.lru_cache(maxsize=None)
def backbone_variables(name):
    mod = jax_backbone(name, False, jnp.float32)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                              backbone_input(name, np.float32)))
    return random_variables(shapes, seed=11 if name == "visual_conv" else 12)


@pytest.mark.parametrize("name", ["visual_conv", "audio_conv"])
def test_narrow_backbone_eval_float32(name):
    var = backbone_variables(name)
    x = backbone_input(name, np.float32)
    want = np.asarray(jax.jit(jax_backbone(name, False, jnp.float32).apply)(var, x))
    net = backbone(name, var).eval()
    got = net(to_nc(x)).detach().numpy()
    assert got.shape == want.shape == (2, 256 if name == "visual_conv" else 128)
    assert rel(want, got) <= OUT_TOL


@pytest.mark.parametrize("name", ["visual_conv", "audio_conv"])
def test_narrow_backbone_train_float64(name):
    var = f64(backbone_variables(name))
    x = backbone_input(name, np.float64)
    with jax.enable_x64(True):
        mod = jax_backbone(name, True, jnp.float64)
        out, upd = jax.jit(lambda v, i: mod.apply(v, i, mutable=["batch_stats"]))(
            var, jnp.asarray(x))
        want, stats = np.asarray(out), f64(upd["batch_stats"])
    net = backbone(name, var).double().train()
    got = net(to_nc(x)).detach().numpy()
    assert rel(want, got) <= OUT_TOL
    back = tm.flax_from_state_dict({f"{name}.{k}": v for k, v in net.state_dict().items()})
    leaves = jax.tree.leaves(back["batch_stats"][name])
    assert len(leaves) == len(jax.tree.leaves(stats))
    for w, g in zip(jax.tree.leaves(stats), leaves):
        assert rel(w, g) <= STATS_TOL


def test_ffn_layer_float64_train_and_eval():
    x = np.random.RandomState(3).randn(6, 64)
    for train in (True, False):
        mod = jm.FFNLayer(64, 16, train=train, dtype=jnp.float64)
        with jax.enable_x64(True):
            shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
            var = f64(random_variables(shapes, seed=4))
            out, upd = mod.apply(var, jnp.asarray(x), mutable=["batch_stats"])
        net = tm.FFNLayer(64, 64, 16)
        net.load_state_dict(tm._from_flax(tm._ffn_pairs(), var))
        net.double().train(train)
        got = net(torch.from_numpy(x)).detach().numpy()
        assert net.fc1.bias is None and net.fc2.bias is not None
        assert rel(np.asarray(out), got) <= OUT_TOL
        if train:
            assert rel(upd["batch_stats"]["bn"]["var"], net.bn.running_var.numpy()) <= STATS_TOL
            assert rel(upd["batch_stats"]["bn"]["mean"],
                       net.bn.running_mean.numpy()) <= STATS_TOL


def test_contrast_loss_matches_jax():
    rng = np.random.RandomState(5)
    for b in (2, 6):
        zv, za = (rng.randn(b, 128).astype(np.float32) for _ in range(2))
        zv /= np.linalg.norm(zv, axis=-1, keepdims=True)
        za /= np.linalg.norm(za, axis=-1, keepdims=True)
        za[0] = zv[0]  # one pair aligned
        lj, aj = jm.contrast_loss(jnp.asarray(zv), jnp.asarray(za))
        lt, at = tm.contrast_loss(torch.from_numpy(zv), torch.from_numpy(za))
        assert abs(float(lj) - float(lt)) <= 1e-6
        assert float(aj) == float(at)


@functools.lru_cache(maxsize=None)
def contrast_variables():
    shapes = jax.eval_shape(lambda: jm.Contrast().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), jnp.zeros((1, 80, 128, 1))))
    return random_variables(shapes, seed=13)


def test_state_dict_round_trips_the_flax_tree_exactly():
    var = contrast_variables()
    net = tm.Contrast()
    net.load_state_dict(tm.state_dict_from_flax(var))  # strict: every key
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = jm.convert_contrast_state_dict(sd)
    ours = tm.flax_from_state_dict(sd)
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(var)
        for w, g in zip(jax.tree.leaves(var), jax.tree.leaves(tree)):
            assert w.shape == g.shape and np.array_equal(w, g)
    # the backbones only, as strip_heads leaves them
    stripped = tm.strip_heads(var)
    assert set(stripped["params"]) == {"visual_conv", "audio_conv"}
    assert set(tm.state_dict_from_flax(stripped)) == {
        k for k in sd if k.startswith(("visual_conv.", "audio_conv."))}
    head = {"params": {"proj": {"kernel": np.random.RandomState(0).randn(3072, 4)
                                .astype(np.float32), "bias": np.arange(4, dtype=np.float32)}}}
    hsd = {k: v.numpy() for k, v in tm.head_state_dict_from_flax(head).items()}
    assert set(hsd) == {"projection.weight", "projection.bias"}
    back = jm.convert_classify_head_state_dict(hsd, prefix="")
    assert np.array_equal(back["params"]["proj"]["kernel"], head["params"]["proj"]["kernel"])
    assert np.array_equal(tm.head_flax_from_state_dict(hsd)["params"]["proj"]["bias"],
                          head["params"]["proj"]["bias"])


def test_reference_names_and_weight_decay_split():
    net = tm.Contrast()
    names = dict(net.named_parameters())
    for key in ("visual_conv.s1.pathway0_stem.conv.weight",
                "visual_conv.s1.pathway0_stem.bn.weight",
                "visual_conv.s2.pathway0_res0.branch1.weight",
                "visual_conv.s5.pathway0_res2.branch2.c_bn.bias",
                "audio_conv.s1.stem.conv2.weight", "audio_conv.s1.stem.bn1.weight",
                "audio_conv.s3.res1.branch2.b1_bn.weight", "audio_conv.s4.res0.branch2.b.weight",
                "visual_mlp.fc1.weight", "audio_mlp.bn.bias", "audio_mlp.fc2.bias"):
        assert key in names, key
    # the split by 'bn' in the torch name selects the JAX package's mask
    mask = jt._bn_param_mask(contrast_variables()["params"], bn=True)
    n_bn_jax = sum(np.asarray(leaf).size for leaf, m in zip(
        jax.tree.leaves(contrast_variables()["params"]), jax.tree.leaves(mask)) if m)
    n_bn_port = sum(p.numel() for n, p in names.items() if "bn" in n)
    assert n_bn_port == n_bn_jax
    assert len(list(net.parameters())) == len(jax.tree.leaves(contrast_variables()["params"]))


def test_fresh_init_follows_flax_defaults():
    net = tm.Contrast(visual_width=8, audio_width=4)
    tm.init_eval_weights(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    assert torch.count_nonzero(sd["visual_conv.s2.pathway0_res0.branch2.c_bn.weight"]) == 0
    assert torch.count_nonzero(sd["audio_conv.s5.res2.branch2.c_bn.weight"]) == 0
    assert torch.all(sd["visual_conv.s2.pathway0_res0.branch2.a_bn.weight"] == 1)
    assert torch.count_nonzero(sd["visual_mlp.fc2.bias"]) == 0
    w = sd["visual_conv.s1.pathway0_stem.conv.weight"]
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1  # lecun normal
    again = tm.Contrast(visual_width=8, audio_width=4)
    tm.init_eval_weights(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def test_remat_blocks_match_plain_blocks():
    """``remat=True`` recomputes blocks on the backward pass: the same
    outputs, gradients and running statistics (updated once)."""
    x = to_nc(backbone_input("visual_conv", np.float64))
    nets = []
    for remat in (False, True):
        net = tm.VisualResNet3D(width=8, remat=remat)
        tm.init_eval_weights(net, torch.Generator().manual_seed(1))
        net.double().train()
        out = net(x.clone().requires_grad_(True))
        out.square().sum().backward()
        nets.append((out.detach(), net))
    (o0, n0), (o1, n1) = nets
    assert torch.allclose(o0, o1, rtol=0, atol=1e-12)
    for (k, p0), p1 in zip(n0.named_parameters(), n1.parameters()):
        assert torch.allclose(p0.grad, p1.grad, rtol=1e-9, atol=1e-12), k
    for (k, b0), b1 in zip(n0.named_buffers(), n1.buffers()):
        assert torch.allclose(b0.to(torch.float64), b1.to(torch.float64),
                              rtol=0, atol=1e-12), k
