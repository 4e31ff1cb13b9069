"""Port k-means (``acav100m_torch.ops.kmeans``, kernel K1's plain version)
against the JAX package: the Pallas kernel in interpret mode, the stacked
``train_step`` over 30 steps with the JAX warmup draws injected, and the
checkpoint dict in both directions."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acav100m_tpu.ops import kmeans as jk
from acav100m_tpu.ops.pallas import kmeans_kernel as jkk
from acav100m_torch.ops import kmeans as tk
from acav100m_torch.ops.kmeans_kernel import fused_assign_update

torch.set_num_threads(1)


@pytest.mark.parametrize("b", [64, 100, 256])
def test_fused_assign_update_matches_pallas(b):
    rng = np.random.RandomState(b)
    m, k, d = 3, 8, 48
    centers = rng.randn(m, k, d).astype(np.float32)
    counts = rng.randint(0, 400, (m, k)).astype(np.float32)
    batch = rng.randn(m, b, d).astype(np.float32)
    # (10000/8)**0.7 ~ 147: a share of the centers is underused
    threshold = float(jnp.maximum(jnp.float32(10000) / k, 0.0) ** 0.7)
    assert 0 < (counts < threshold).sum() < m * k
    jb, jc, jd, jm = jkk.fused_assign_update(
        jnp.asarray(centers), jnp.asarray(counts), jnp.asarray(batch),
        jnp.float32(threshold), tile_b=64, interpret=True)
    tb, tc, td, tm = fused_assign_update(
        torch.from_numpy(centers), torch.from_numpy(counts), torch.from_numpy(batch),
        threshold)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # different summation orders: 1e-5 relative on sums of O(10) values
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX tests' idiom: run the Pallas kernel in interpret mode."""
    orig = jkk.fused_assign_update

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jkk, "fused_assign_update", interp)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_jax_over_30_steps(use_pallas, interpret_pallas):
    rng = np.random.RandomState(7)
    dims, k, b, lr = [48, 30, 20], 8, 16, 0.2
    m, dmax = len(dims), max(dims)
    jstate = jk.init_state(jax.random.PRNGKey(0), dims, k)
    tstate = tk.init_state(dims, k, centers=np.asarray(jstate.centers))
    np.testing.assert_array_equal(tstate.centers.numpy(), np.asarray(jstate.centers))
    jstep = jax.jit(functools.partial(jk.train_step, use_pallas=use_pallas))
    key = jax.random.PRNGKey(1)
    protos = rng.randn(m, 5, dmax).astype(np.float32) * 3
    warm, fallback_steps = 0, 0
    for step in range(30):
        lab = rng.randint(0, 5, (m, b))
        batch = protos[np.arange(m)[:, None], lab] + rng.randn(m, b, dmax).astype(np.float32)
        for i, dd in enumerate(dims):
            batch[i, :, dd:] = 0.0
        key, sub = jax.random.split(key)
        warm += int(jstate.count) < 10 * k
        jstate, jmean = jstep(jstate, jnp.asarray(batch), lr, sub)
        rand = np.asarray(jax.random.uniform(sub, (m, k, b), dtype=jnp.float32))
        prev_fallback = int(tstate.fallback)
        tstate, tmean = tk.train_step(tstate, torch.from_numpy(batch), lr,
                                      rand=torch.from_numpy(rand.copy()), use_pallas=use_pallas)
        fallback_steps += int(tstate.fallback) - prev_fallback
        np.testing.assert_array_equal(tstate.counts.numpy(), np.asarray(jstate.counts))
        assert tstate.count == int(jstate.count)
        assert int(tstate.fallback) == int(jstate.fallback)
        np.testing.assert_allclose(tstate.centers.numpy(), np.asarray(jstate.centers),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    assert warm == 5  # 80 warmup samples at 16 a step
    assert 0 < fallback_steps < 30  # the lr fallback both fires and not


def test_assign_step_matches_jax():
    rng = np.random.RandomState(3)
    m, k, d, b = 2, 6, 12, 40
    jstate = jk.init_state(jax.random.PRNGKey(0), [d, d], k)._replace(
        centers=jnp.asarray(rng.randn(m, k, d).astype(np.float32)),
        counts=jnp.asarray(rng.randint(0, 50, (m, k)).astype(np.float32)),
        count=jnp.asarray(500, jnp.int32))
    tstate = tk.load_attrs(jk.get_attrs(jstate))
    batch = rng.randn(m, b, d).astype(np.float32)
    np.testing.assert_array_equal(
        tk.assign_step(tstate, torch.from_numpy(batch)).numpy(),
        np.asarray(jk.assign_step(jstate, jnp.asarray(batch))))


def test_attrs_cross_load_both_ways():
    rng = np.random.RandomState(5)
    jstate = jk.init_state(jax.random.PRNGKey(2), [10, 7], 4)._replace(
        counts=jnp.asarray(rng.randint(0, 9, (2, 4)).astype(np.float32)),
        count=jnp.asarray(321, jnp.int32), fallback=jnp.asarray(3, jnp.int32))
    jattrs = jk.get_attrs(jstate, lr=jk.lr_schedule(1))
    tstate = tk.load_attrs(jattrs)
    tattrs = tk.get_attrs(tstate, lr=tk.lr_schedule(1))
    assert set(tattrs) == set(jattrs)
    for key, val in jattrs.items():
        if isinstance(val, np.ndarray):
            assert tattrs[key].dtype == val.dtype
            np.testing.assert_array_equal(tattrs[key], val)
        else:
            assert tattrs[key] == val and type(tattrs[key]) is type(val)
    back = jk.load_attrs(tattrs)
    for a, b in zip(back, jstate):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lr_schedule_and_pad_features():
    for epoch in range(12):
        assert tk.lr_schedule(epoch) == jk.lr_schedule(epoch)
    x = np.ones((2, 3, 5), np.float32)
    np.testing.assert_array_equal(tk.pad_features(x, 8), jk.pad_features(x, 8))
