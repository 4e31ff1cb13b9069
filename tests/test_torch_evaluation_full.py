"""One contrastive train step of the full-width ``Contrast`` (R3D-50 width
64, audio ResNet-50 width 32) in the port against the JAX package's
``make_pretrain_step``, from one seeded weight tree, at B=2, T=4, 32^2:
loss and accuracy, every updated parameter and the running statistics.

The step runs in float64 on both sides. In float32 the two differ by
about 6e-4 in the loss: batch norm in train mode over the 4 values a
channel holds at ``s5`` (2 clips x 2 frames x 1 x 1) amplifies rounding
of 1e-7 about ten thousandfold, and the JAX step's own jitted and eager
forms differ by as much. The frames are 0 or 255, whose scaling to [0, 1]
is exact however it is rounded (the JAX package's jitted step scales
other frames with another rounding than its eager form, and the two then
differ by 1.5e-4 in float64);
``test_normalize_visual_matches_jax`` holds the scaling itself."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from acav100m_tpu.evaluation import models as jm
from acav100m_tpu.evaluation import train as jt
from acav100m_torch.evaluation import models as tm
from acav100m_torch.evaluation import train as tt
from tests.torch_parity import random_variables

torch.set_num_threads(1)

LOSS_TOL = 1e-5  # absolute
PARAM_RTOL = 1e-4  # relative L2 of each updated parameter
STATS_RTOL = 1e-6  # running statistics, relative to their largest magnitude


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def test_normalize_visual_matches_jax():
    frames = np.random.RandomState(0).randint(0, 256, (2, 4, 8, 8, 3)).astype(np.uint8)
    want = np.asarray(jt.normalize_visual(jnp.asarray(frames)))
    got = tt.normalize_visual(torch.from_numpy(frames))
    assert got.shape == (2, 3, 4, 8, 8) and got.dtype == torch.float32
    assert np.abs(np.moveaxis(got.numpy(), 1, -1) - want).max() <= 1e-6


def test_full_width_pretrain_step_matches_jax():
    rng = np.random.RandomState(0)
    visual = (rng.randint(0, 2, (2, 4, 32, 32, 3)) * 255).astype(np.uint8)
    audio = rng.randn(2, 80, 128, 1)
    with jax.enable_x64(True):
        model = jm.Contrast(train=True, dtype=jnp.float64)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros(visual.shape), jnp.asarray(audio)))
        var = f64(random_variables(shapes, seed=3))
        opt = jt.build_optimizer("adamw", jt.lr_schedule("linear", 1e-3, 10, warmup_steps=0))
        state = jt.TrainState(var["params"], var["batch_stats"], opt.init(var["params"]),
                              jnp.zeros((), jnp.int32))
        new, metrics = jt.make_pretrain_step(model, opt)(
            state, jnp.asarray(visual), jnp.asarray(audio))
        want_params, want_stats = f64(new.params), f64(new.batch_stats)
        want_loss, want_acc = float(metrics["loss"]), float(metrics["acc"])

    port = tt.init_pretrain(0, tt.lr_schedule("linear", 1e-3, 10, warmup_steps=0), "cpu")
    port.model.load_state_dict(tm.state_dict_from_flax(var))
    port.model.double()
    port.optimizer = tt.build_optimizer("adamw", port.model.named_parameters(),
                                        port.schedule)
    port, got = tt.make_pretrain_step(port)(port, visual, audio)
    assert port.step == 1
    assert abs(float(got["loss"]) - want_loss) <= LOSS_TOL
    assert float(got["acc"]) == want_acc
    tree = tm.flax_from_state_dict(port.model.state_dict())
    moved = 0
    for w, g, p0 in zip(jax.tree.leaves(want_params), jax.tree.leaves(tree["params"]),
                        jax.tree.leaves(var["params"])):
        assert np.linalg.norm(w - g) <= PARAM_RTOL * np.linalg.norm(w)
        moved += int(not np.array_equal(g, p0))
    assert moved == len(jax.tree.leaves(var["params"]))  # lr > 0: every param moved
    for w, g in zip(jax.tree.leaves(want_stats), jax.tree.leaves(tree["batch_stats"])):
        assert np.abs(w - g).max() <= STATS_RTOL * np.abs(w).max()
