"""The port's evaluation training (``acav100m_torch.evaluation.train``)
against the JAX package's: the lr policies, the torch optimizers against
the JAX package's torch-style optax chains, the linear head's step with
one dropout mask, checkpoints read across the two packages in both
directions, and resuming from a checkpoint."""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acav100m_tpu.evaluation import models as jm
from acav100m_tpu.evaluation import train as jt
from acav100m_torch.evaluation import models as tm
from acav100m_torch.evaluation import train as tt
from tests.torch_parity import random_variables

torch.set_num_threads(1)

FEATURE_RTOL = 1e-5  # frozen features, relative to their largest magnitude


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("policy,total,warmup,start,end", [
    ("linear", 50, 10, 0.3, 0.0), ("linear", 50, 0, 0.0, 0.01),
    ("cosine", 50, 10, 0.2, 0.0), ("cosine", 40, 0, 0.0, 0.05),
    ("constant", 50, 10, 0.0, 0.0)])
def test_lr_schedule_matches_jax_in_float64(policy, total, warmup, start, end):
    ours = tt.lr_schedule(policy, 0.7, total, warmup_steps=warmup, warmup_start_lr=start,
                          end_lr=end)
    with jax.enable_x64(True):
        theirs = jt.lr_schedule(policy, 0.7, total, warmup_steps=warmup,
                                warmup_start_lr=start, end_lr=end)
        for step in range(total + 3):
            assert abs(ours(step) - float(theirs(step))) <= 1e-12, step
    if policy == "linear" and warmup:
        assert ours(0) == 0.0  # the linear warmup ramps from 0, not warmup_start_lr
    with pytest.raises(ValueError):
        tt.lr_schedule("step", 0.1, 10)


# (torch name, shape) of a tiny model with a BN group; its flax tree pairs
# fc kernels (transposed) and bn scale/bias
SHAPES = [("fc1.weight", (4, 3)), ("bn.weight", (4,)), ("bn.bias", (4,)),
          ("fc2.weight", (2, 4)), ("fc2.bias", (2,))]


def to_tree(flat):
    tree = {}
    for name, arr in flat.items():
        mod, leaf = name.split(".")
        if mod == "bn":
            key = {"weight": "scale", "bias": "bias"}[leaf]
        else:
            key = {"weight": "kernel", "bias": "bias"}[leaf]
            arr = arr.T if leaf == "weight" else arr
        tree.setdefault(mod, {})[key] = jnp.asarray(arr)
    return tree


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adam", {}), ("sgd", {}),
                                     ("sgd", {"weight_decay": 0.0})])
def test_optimizer_trajectories_match_jax(name, kw):
    """Five steps on one gradient stream (linear lr with 2 warmup steps, so
    step 0 runs at lr 0), weight decay 0.05 on the rest and 0 on the BN
    group: the parameters after each step within 1e-12 in float64."""
    rng = np.random.RandomState(1)
    init = {n: rng.uniform(-0.5, 0.5, s) for n, s in SHAPES}
    grads = [{n: rng.uniform(-1, 1, s) for n, s in SHAPES} for _ in range(5)]
    kw = {"weight_decay": 0.05, **kw}
    module = torch.nn.Module()
    params = {}
    for n, _ in SHAPES:
        params[n] = torch.nn.Parameter(torch.from_numpy(init[n].copy()))
    for n, p in params.items():
        mod, leaf = n.split(".")
        if not hasattr(module, mod):
            module.add_module(mod, torch.nn.Module())
        getattr(module, mod).register_parameter(leaf, p)
    ours = tt.build_optimizer(name, module.named_parameters(),
                              tt.lr_schedule("linear", 0.1, 5, warmup_steps=2), **kw)
    with jax.enable_x64(True):
        schedule = jt.lr_schedule("linear", 0.1, 5, warmup_steps=2)
        opt = jt.build_optimizer(name, schedule, **kw)
        tree = to_tree(init)
        state = opt.init(tree)
        for step in range(5):
            updates, state = opt.update(to_tree(grads[step]), state, tree)
            tree = optax.apply_updates(tree, updates)
            for n, p in params.items():
                p.grad = torch.from_numpy(grads[step][n].copy())
            tt.set_lr(ours, tt.lr_schedule("linear", 0.1, 5, warmup_steps=2)(step))
            ours.step()
            want = _flat(tree)
            for n, p in params.items():
                assert np.abs(want[n] - p.detach().numpy()).max() <= 1e-12, (step, n)
    decay = {g["weight_decay"] for g in ours.param_groups}
    assert decay == {kw["weight_decay"], 0.0}


def _flat(tree):
    out = {}
    for mod, leaves in tree.items():
        for key, arr in leaves.items():
            leaf = "weight" if key in ("kernel", "scale") else "bias"
            a = np.asarray(arr)
            out[f"{mod}.{leaf}"] = a.T if key == "kernel" else a
    return out
def test_head_step_with_a_shared_dropout_mask():
    """Five SGD steps of the linear head (cosine lr) in both packages, the
    JAX side's dropout masks read from its own draws and handed to the
    port's head: logits, losses and params within 1e-6."""
    rng = np.random.RandomState(9)
    num_classes, steps, base_lr = 4, 5, 0.05
    feats = [rng.randn(6, 32).astype(np.float32) + 0.1 for _ in range(steps)]
    labels = [rng.randint(0, num_classes, 6) for _ in range(steps)]
    head = jm.ClassifyHead(num_classes=num_classes, train=True)
    key = jax.random.PRNGKey(0)
    params = head.init({"params": key, "dropout": key}, feats[0])["params"]
    schedule = jt.lr_schedule("cosine", base_lr, steps)
    opt = jt.build_optimizer("sgd", schedule)
    opt_state = opt.init(params)

    port = tm.ClassifyHead(32, num_classes)
    port.load_state_dict(tm.head_state_dict_from_flax({"params": params}))
    tsched = tt.lr_schedule("cosine", base_lr, steps)
    step = tt.make_head_step(port, tt.build_optimizer("sgd", port.named_parameters(), tsched),
                             tsched)
    for n in range(steps):
        key, sub = jax.random.split(key)

        def loss_fn(p):
            logits, inter = head.apply({"params": p}, feats[n], rngs={"dropout": sub},
                                       capture_intermediates=True, mutable=["intermediates"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels[n]).mean()
            return loss, inter["intermediates"]["Dropout_0"]["__call__"][0]

        (loss, dropped), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        mask = torch.from_numpy(np.asarray(dropped) != 0)
        assert 0 < int(mask.sum()) < mask.numel()
        tloss, _ = step(torch.from_numpy(feats[n]), torch.from_numpy(labels[n]), mask, n)
        assert abs(float(loss) - float(tloss)) <= 1e-6
        got = tm.head_flax_from_state_dict(port.state_dict())["params"]["proj"]
        assert rel(params["proj"]["kernel"], got["kernel"]) <= 1e-6
        assert np.abs(np.asarray(params["proj"]["bias"]) - got["bias"]).max() <= 1e-6
    port.eval()
    want = np.asarray(jm.ClassifyHead(num_classes=num_classes).apply({"params": params}, feats[0]))
    assert rel(want, port(torch.from_numpy(feats[0])).detach().numpy()) <= 1e-6


def narrow_state(seed=0):
    """A narrow ``Contrast`` (widths 8 and 4) with adamw, as ``init_pretrain``
    builds the full-width one."""
    model = tm.Contrast(visual_width=8, audio_width=4)
    tm.init_eval_weights(model, torch.Generator().manual_seed(seed))
    schedule = tt.lr_schedule("linear", 1e-3, 10, warmup_steps=2)
    return tt.TrainState(model.train(), tt.build_optimizer(
        "adamw", model.named_parameters(), schedule), schedule)


def tiny_batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8),
            rng.randn(2, 80, 128, 1).astype(np.float32))


def test_resume_from_checkpoint_continues_the_same_run(tmp_path):
    """Three steps in one go equal two steps, a checkpoint, a fresh state
    loaded from it and a third step: parameters, batch statistics and the
    optimizer's moments bit for bit. (BN's ``num_batches_tracked``, which
    the flax layout lacks, is read only without a momentum: not here.)"""
    batches = [tiny_batch(s) for s in range(3)]
    straight = narrow_state()
    step = tt.make_pretrain_step(straight)
    for v, a in batches:
        straight, _ = step(straight, v, a)
    first = narrow_state()
    step = tt.make_pretrain_step(first)
    for v, a in batches[:2]:
        first, _ = step(first, v, a)
    path = tt.save_checkpoint(tmp_path, first, epoch=4, name="step_latest")
    payload = pickle.loads(path.read_bytes())
    assert set(payload) == {"params", "batch_stats", "opt_state", "step", "epoch"}
    assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(payload["params"]))
    resumed, epoch = tt.load_checkpoint(path, narrow_state(seed=1))
    assert (epoch, resumed.step) == (4, 2)
    resumed, _ = tt.make_pretrain_step(resumed)(resumed, *batches[2])
    assert resumed.step == straight.step == 3
    for (k, want), got in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().values()):
        assert k.endswith("num_batches_tracked") or torch.equal(want, got), k
    want_opt = straight.optimizer.state_dict()["state"]
    got_opt = resumed.optimizer.state_dict()["state"]
    for i, st in want_opt.items():
        for key, val in st.items():
            assert torch.equal(val, got_opt[i][key]), (i, key)


def test_orbax_backend_is_the_jax_packages(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        tt.save_checkpoint(tmp_path, narrow_state(), epoch=0, backend="orbax")
    (tmp_path / "x.orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tt.load_checkpoint(tmp_path / "x.orbax", narrow_state())


@functools.lru_cache(maxsize=None)
def contrast_variables():
    shapes = jax.eval_shape(lambda: jm.Contrast().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), jnp.zeros((1, 80, 128, 1))))
    return random_variables(shapes, seed=21)


def test_checkpoints_read_across_packages(tmp_path):
    """A port checkpoint read by the JAX package's ``load_pretrained_backbone``
    and a JAX checkpoint read by the port's: the same backbone trees, and
    the frozen multimodal features of the full-width backbones on either
    side within 1e-5 of the other's."""
    var = contrast_variables()
    state = tt.init_pretrain(0, device="cpu")
    state.model.load_state_dict(tm.state_dict_from_flax(var))
    port_ckpt = tt.save_checkpoint(tmp_path / "port", state, epoch=0)
    jax_ckpt = jt.save_checkpoint(tmp_path / "jax", jt.TrainState(
        var["params"], var["batch_stats"], {}, jnp.zeros((), jnp.int32)), epoch=0)

    from_port = jt.load_pretrained_backbone(port_ckpt)
    assert jax.tree.structure(from_port) == jax.tree.structure(jm.strip_heads(var))
    for want, got in zip(jax.tree.leaves(jm.strip_heads(var)), jax.tree.leaves(from_port)):
        assert np.array_equal(want, got)
    visual, audio = tiny_batch(5)
    want = np.asarray(jt.make_feature_fn(from_port, "multimodal")(
        jnp.asarray(visual), jnp.asarray(audio)))
    assert want.shape == (2, 2048 + 1024)
    for ckpt in (port_ckpt, jax_ckpt):
        got = tt.make_feature_fn(tt.load_pretrained_backbone(ckpt), "multimodal", "cpu")(
            visual, audio)
        assert got.shape == want.shape and not got.requires_grad
        assert rel(want, got.numpy()) <= FEATURE_RTOL, ckpt
        ckpt.unlink()  # 170 MB each at full width
