"""The evaluation models' ``dtype`` (flax's ``dtype`` with float32
``param_dtype``) in bfloat16 against the JAX package's.

Tolerances, with their reasons:

* eval mode, full width (B=4, 4 frames of 32^2, the seed-3 tree): each
  package's bf16 embeddings against the JAX package's float64 ones; the
  port's relative L2 error may be at most twice the JAX package's plus
  1e-3 (bf16 rounds each of ~100 layers at 2^-9; both land near 8e-3
  visual and 5e-3 audio), and the two bf16 embeddings within 2.5e-2 of
  each other;
* train mode, module by module (``Bottleneck3D``, ``Bottleneck2D`` both
  ways, ``FFNLayer``) at batches where every batch-norm channel holds at
  least 256 values: outputs within 1e-2 of their max (a few bf16 steps),
  each parameter's gradient within 3e-2 relative L2 and the running
  statistics within 1e-4 of their max, against the JAX package's bf16
  forward and ``jax.grad``. A whole train-mode net is not compared: batch
  norm over the few values a channel holds at these sizes amplifies bf16
  rounding, in the JAX package against itself too (its bf16 loss is 1.086
  against 0.838 in float32 at B=4, 32^2), so the full step is checked
  for what it must keep: float32 parameters and statistics, a finite
  loss, every parameter moved."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.evaluation import models as jm
from acav100m_tpu.evaluation import train as jt
from acav100m_torch.evaluation import models as tm
from acav100m_torch.evaluation import train as tt
from tests.torch_parity import random_variables

torch.set_num_threads(1)

BF16 = torch.bfloat16
EVAL_FLOOR = 1e-3  # added to twice the JAX package's own bf16 error
EVAL_CROSS_TOL = 2.5e-2  # port bf16 against JAX bf16 embeddings, relative L2
OUT_TOL = 1e-2  # train-mode module outputs, relative to their max
GRAD_RTOL = 3e-2  # each parameter's gradient, relative L2
STATS_TOL = 1e-4  # running statistics after the train forward, relative to their max


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def to_nc(x: np.ndarray) -> torch.Tensor:
    """NDHWC / NHWC -> NCDHW / NCHW."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    return ((rng.randint(0, 2, (b, 4, 32, 32, 3)) * 255).astype(np.uint8),
            rng.randn(b, 80, 128, 1).astype(np.float32))


@functools.lru_cache(maxsize=None)
def contrast_variables():
    visual, audio = batch()
    shapes = jax.eval_shape(lambda: jm.Contrast().init(
        jax.random.PRNGKey(0), jnp.zeros(visual.shape), jnp.asarray(audio)))
    return random_variables(shapes, seed=3)


def test_parameters_stay_float32_and_outputs_are_bf16():
    net = tm.Contrast(visual_width=8, audio_width=4, dtype=BF16)
    tm.init_eval_weights(net, torch.Generator().manual_seed(0))
    visual, audio = batch(b=2)
    v, a = tt.model_inputs(visual, audio, "cpu", next(net.parameters()).dtype)
    assert v.dtype == a.dtype == torch.float32  # the first convs cast them
    zv, za = net.train()(v, a)
    loss, acc = tm.contrast_loss(zv, za)
    assert zv.dtype == za.dtype == (zv @ za.T).dtype == loss.dtype == BF16
    assert acc.dtype == torch.float32
    loss.backward()
    assert {p.dtype for p in net.parameters()} == {p.grad.dtype for p in net.parameters()} \
        == {torch.float32}
    floats = [b for k, b in net.named_buffers() if not k.endswith("num_batches_tracked")]
    assert {b.dtype for b in floats} == {torch.float32}
    assert all(bool(torch.isfinite(b).all()) for b in floats)
    head = tm.ClassifyHead(64, 5, dtype=BF16).eval()
    assert head(torch.randn(3, 64)).dtype == BF16 and head.projection.weight.dtype == torch.float32
    assert tm.Contrast(visual_width=8, audio_width=4).visual_mlp.fc2.compute_dtype is None


def test_full_width_eval_embeddings_within_twice_the_jax_error():
    var = contrast_variables()
    visual, audio = batch()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), var)
        want = jm.Contrast(train=False, dtype=jnp.float64).apply(
            v64, jt.normalize_visual(jnp.asarray(visual)).astype(jnp.float64),
            jnp.asarray(audio, jnp.float64))
        want = [np.asarray(w) for w in want]
    jax_bf16 = jax.jit(jm.Contrast(train=False, dtype=jnp.bfloat16).apply)(
        var, jt.normalize_visual(jnp.asarray(visual)), jnp.asarray(audio))
    assert all(z.dtype == jnp.bfloat16 for z in jax_bf16)
    jax_bf16 = [np.asarray(z.astype(jnp.float32)) for z in jax_bf16]
    net = tm.Contrast(dtype=BF16)
    net.load_state_dict(tm.state_dict_from_flax(var))
    with torch.no_grad():
        got = net.eval()(*tt.model_inputs(visual, audio, "cpu"))
    assert all(z.dtype == BF16 for z in got)
    got = [z.float().numpy() for z in got]
    for g, j, w in zip(got, jax_bf16, want):
        assert rel_l2(g, w) <= 2 * rel_l2(j, w) + EVAL_FLOOR
        assert rel_l2(g, j) <= EVAL_CROSS_TOL


def _block_pairs(names, branch1: bool):
    """(port module, flax path, is a conv) of one bottleneck block."""
    out = [("branch1", ("branch1",), True), ("branch1_bn", ("branch1_bn",), False)] \
        if branch1 else []
    for n in names:
        out += [(f"branch2.{n}", (n,), True), (f"branch2.{n}_bn", (f"{n}_bn",), False)]
    return out


# name -> (JAX module at a dtype, port module in bf16, its (port, flax) pairs,
# the input's NDHWC / NHWC / (B, D) shape): every BN channel holds >= 256 values
MODULES = {
    "bottleneck3d": (
        lambda dt: jm.Bottleneck3D(dim_out=32, dim_inner=8, temp_kernel=3,
                                   spatial_stride=2, train=True, dtype=dt),
        lambda: tm.Bottleneck3D(16, 32, 8, 3, 2, dtype=BF16),
        _block_pairs("abc", True), (2, 4, 16, 16, 16)),
    "bottleneck2d_separable": (
        lambda dt: jm.Bottleneck2D(dim_out=32, dim_inner=8, stride=2, separable=True,
                                   train=True, dtype=dt),
        lambda: tm.Bottleneck2D(16, 32, 8, 2, separable=True, dtype=BF16),
        _block_pairs(("a", "b1", "b2", "c"), True), (2, 32, 32, 16)),
    "bottleneck2d": (
        lambda dt: jm.Bottleneck2D(dim_out=32, dim_inner=8, stride=2, train=True, dtype=dt),
        lambda: tm.Bottleneck2D(16, 32, 8, 2, dtype=BF16),
        _block_pairs("abc", True), (2, 32, 32, 16)),
    "ffn": (
        lambda dt: jm.FFNLayer(64, 16, train=True, dtype=dt),
        lambda: tm.FFNLayer(64, 64, 16, dtype=BF16), tm._ffn_pairs(), (256, 64)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_train_mode_module_matches_jax_bf16(name):
    jax_mod, port_mod, pairs, shape = MODULES[name]
    rng = np.random.RandomState(sorted(MODULES).index(name))
    x = rng.randn(*shape).astype(np.float32)
    mod = jax_mod(jnp.bfloat16)
    var = random_variables(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), x)),
                           seed=5)
    out_shape = jax.eval_shape(lambda: mod.apply(var, x, mutable=["batch_stats"]))[0].shape
    w = rng.randn(*out_shape).astype(np.float32)

    def loss(params):
        out, upd = mod.apply({"params": params, "batch_stats": var["batch_stats"]},
                             jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * w), (out, upd["batch_stats"])

    grads, (want, want_stats) = jax.grad(loss, has_aux=True)(var["params"])
    assert want.dtype == jnp.bfloat16
    nc = (lambda a: torch.from_numpy(a)) if len(shape) == 2 else to_nc
    net = port_mod()
    net.load_state_dict(tm._from_flax(pairs, var))
    out = net.train()(nc(x))
    assert out.dtype == BF16
    (out.float() * nc(w)).sum().backward()
    got = out.detach().float().numpy()
    if len(shape) > 2:
        got = np.moveaxis(got, 1, -1)
    assert rel_max(got, np.asarray(want.astype(jnp.float32))) <= OUT_TOL
    sd = {k: p.grad for k, p in net.named_parameters()}
    sd.update(dict(net.named_buffers()))
    tree = tm._to_flax(pairs, sd)
    for g, j in zip(jax.tree.leaves(tree["params"]), jax.tree.leaves(grads)):
        assert g.dtype == np.float32 and g.shape == j.shape
        assert rel_l2(g, j) <= GRAD_RTOL
    leaves = jax.tree.leaves(tree["batch_stats"])
    assert len(leaves) == len(jax.tree.leaves(want_stats))
    for g, j in zip(leaves, jax.tree.leaves(want_stats)):
        assert g.dtype == np.float32 and rel_max(g, j) <= STATS_TOL


def test_full_width_bf16_step_keeps_float32_state():
    state = tt.init_pretrain(0, tt.lr_schedule("linear", 1e-3, 10, warmup_steps=0), "cpu",
                             dtype=BF16)
    # the seed-3 tree: a fresh init's zero c_bn gammas leave the convs before
    # them without gradient, and weight decay alone rounds away in float32
    state.model.load_state_dict(tm.state_dict_from_flax(contrast_variables()))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    visual, audio = batch(seed=1)
    state, metrics = tt.make_pretrain_step(state)(state, visual, audio)
    assert state.step == 1 and metrics["loss"].dtype == BF16
    assert np.isfinite(float(metrics["loss"])) and 0 <= float(metrics["acc"]) <= 100
    after = state.model.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
            continue
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), k
    moved = [not torch.equal(p, before[k]) for k, p in state.model.named_parameters()]
    assert all(moved)  # lr > 0: every parameter moved
