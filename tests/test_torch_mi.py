"""Stage 6 compute: the port's ``BatchGreedySelector`` against the JAX
package's on seeded assignments with duplicated rows (exact score ties,
which must go to the lowest index), in float32 and float64.

The cache is seeded with 20 start rows. From a nearly empty cache many
distinct candidates tie mathematically (their per-pair terms are the same
multiset) and each framework's rounding, not the algorithm, picks among
them; PARITY.md documents the same effect against the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.ops import mi as jmi
from acav100m_tpu.ops.pairing import get_cluster_pairing as jpairing
from acav100m_torch.ops import mi as tmi
from acav100m_torch.ops.pairing import get_cluster_pairing

torch.set_num_threads(1)

V, D, C, B, K = 200, 10, 8, 20, 4


def _assignments(seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, C, (V, D))
    a[150:180] = a[60:90]  # duplicated rows score exactly alike
    a[180:200] = a[60]
    return a


START = list(range(20))


@pytest.mark.parametrize("keep_unselected", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_batch_greedy_matches_jax(keep_unselected, dtype, tol):
    a = _assignments()
    combos = get_cluster_pairing([(str(i), "x") for i in range(D)], "combination")
    assert combos == jpairing([(str(i), "x") for i in range(D)], "combination")
    kwargs = dict(ncentroids=C, batch_size=B, selection_size=K,
                  keep_unselected=keep_unselected)
    js = jmi.BatchGreedySelector(a, combos, rng=np.random.RandomState(1),
                                 dtype=dtype, **kwargs)
    ts = tmi.BatchGreedySelector(a, combos, rng=np.random.RandomState(1),
                                 dtype=dtype, device="cpu", **kwargs)
    subset = 60
    jsel, jgain, _, _ = js.run_greedy(subset, START)
    tsel, tgain, _, _ = ts.run_greedy(subset, START)
    assert tsel == jsel
    ties = [i for i in range(len(tgain) - 1) if i % K != K - 1 and tgain[i] == tgain[i + 1]]
    assert ties  # some rounds select exactly tied candidates
    np.testing.assert_allclose(tgain, jgain, rtol=tol, atol=tol)
    # the caches end identical: folds add exact integer counts
    for key in ("N", "a", "b", "n"):
        np.testing.assert_array_equal(ts.cache[key].numpy(), np.asarray(js.cache[key]))
    assert ts.cache["N"].dtype == getattr(torch, dtype)


def test_modify_k_grows_k_without_keep_unselected():
    a = _assignments(2)
    combos = get_cluster_pairing([(str(i), "x") for i in range(D)], "combination")
    for keep, want in ((True, 2), (False, 15)):
        ts = tmi.BatchGreedySelector(a, combos, ncentroids=C, batch_size=B,
                                     selection_size=2, keep_unselected=keep, seed=0)
        js = jmi.BatchGreedySelector(a, combos, ncentroids=C, batch_size=B,
                                     selection_size=2, keep_unselected=keep, seed=0)
        assert ts.modify_k(150) == js.modify_k(150) == want


def test_stable_top_k_ties_to_lowest_index():
    scores = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, -float("inf"), 3.0])
    vals, idx = tmi.stable_top_k(scores, 4)
    assert idx.tolist() == [1, 2, 4, 6]
    jv, ji = __import__("jax").lax.top_k(jnp.asarray(scores.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_score_and_fold_match_jax_with_weights():
    rng = np.random.RandomState(4)
    a = rng.randint(0, C, (30, D))
    combos = get_cluster_pairing([(str(i), "x") for i in range(D)], "combination")
    pairs = tmi.pair_assignments(a, combos)
    np.testing.assert_array_equal(pairs, jmi.pair_assignments(a, combos))
    jc = jmi.init_cache(len(combos), C, jnp.float32)
    tc = tmi.init_cache(len(combos), C, torch.float32)
    w = np.array([1, 0, 1, 1, 0] * 2, np.float32)
    jc = jmi.add_candidates_to_cache(jc, jnp.asarray(pairs[:10]), C, jnp.asarray(w))
    tc = tmi.add_candidates_to_cache(tc, torch.from_numpy(pairs[:10]), C, torch.from_numpy(w))
    for key in jc:
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    js, ts = jmi.mem_stats(jc), tmi.mem_stats(tc)
    np.testing.assert_allclose(
        tmi.score_candidates_mem(tc, ts, torch.from_numpy(pairs[10:]), C).numpy(),
        np.asarray(jmi.score_candidates_mem(jc, js, jnp.asarray(pairs[10:]), C)),
        rtol=1e-5, atol=1e-6)
