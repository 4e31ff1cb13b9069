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

from . import batch_mi_states as bm

torch.set_num_threads(1)

V, D, C, B, K = 200, 10, 8, 20, 4


_assignments = bm.parity_assignments  # duplicated rows score exactly alike
START = bm.PARITY["start"]


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
    if dtype == "float32":  # the JAX run the card's fused step is held to
        record = np.load(bm.JAX_RECORD)
        want = {"picks": jsel, "gains": jgain,
                **{key: js.cache[key] for key in ("N", "a", "b", "n")}}
        for name, value in want.items():
            np.testing.assert_array_equal(record[bm.record_key(keep_unselected, name)],
                                          np.asarray(value))


def test_modify_k_grows_k_without_keep_unselected():
    a = _assignments(2)
    combos = get_cluster_pairing([(str(i), "x") for i in range(D)], "combination")
    for keep, want in ((True, 2), (False, 15)):
        ts = tmi.BatchGreedySelector(a, combos, ncentroids=C, batch_size=B,
                                     selection_size=2, keep_unselected=keep, seed=0,
                                     device="cpu")
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


def _step_op_by_op(cache, stats, pairs_all, ids, valid, k, pair_weights=None):
    """The batch step written out op by op: gather, incremental score, a
    -inf scalar where the mask is off, stable top-k, fold, statistics."""
    pairs = pairs_all[torch.as_tensor(ids)]
    mask = torch.as_tensor(np.arange(len(ids)) < valid)
    scores = tmi.score_candidates_mem(cache, stats, pairs, bm.C, pair_weights=pair_weights)
    scores = torch.where(mask, scores, torch.tensor(-float("inf")))
    top_scores, top_idx = tmi.stable_top_k(scores, k)
    cache = tmi.add_candidates_to_cache(cache, pairs[top_idx], bm.C, weights=mask[top_idx])
    return top_idx, top_scores, cache, tmi.mem_stats(cache)


@pytest.mark.parametrize("state", bm.STATES)
def test_batch_mi_step_twin_equals_the_eager_step(state):
    cache, stats, pairs_all, ids, valid, k, weights = bm.state(state, "cpu")
    want = _step_op_by_op(cache, stats, pairs_all, ids, valid, k, weights)
    got = tmi.batch_mi_step_ref(cache, stats, pairs_all, torch.as_tensor(ids), valid, k, bm.C,
                                weights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for key in want[2]:
        torch.testing.assert_close(got[2][key], want[2][key], rtol=1e-6, atol=0)
    for key in want[3]:
        torch.testing.assert_close(got[3][key], want[3][key], rtol=1e-6, atol=0)
    # the selector's own step on the CPU takes the same picks into the same cache
    sel = tmi.BatchGreedySelector(np.zeros((bm.V, bm.D), np.int64), bm.COMBOS, bm.C,
                                  batch_size=bm.B, selection_size=k, device="cpu",
                                  pair_weights=None if weights is None else weights.numpy())
    assert not sel.fused
    sel.pairs_all, sel.cache, sel.stats = pairs_all, cache, stats
    top_idx, top_scores = sel._read_picks(sel._step(ids, valid))
    np.testing.assert_array_equal(top_idx, want[0].numpy())
    np.testing.assert_array_equal(top_scores, want[1].double().numpy())
    for key in want[2]:
        torch.testing.assert_close(sel.cache[key], want[2][key], rtol=1e-6, atol=0)
    if state == "tail":
        assert (top_idx >= valid).any()  # pads come last, folded with weight 0
        assert float(sel.cache["n"][0] - cache["n"][0]) == valid


@pytest.mark.parametrize("device,dtype,scorer,group,fused", [
    ("cuda", torch.float32, "mem", None, True),
    ("cuda:0", torch.float32, "mem", None, True),
    ("cpu", torch.float32, "mem", None, False),
    ("cuda", torch.bfloat16, "mem", None, False),
    ("cuda", torch.float64, "mem", None, False),
    ("cuda", torch.float32, "mi", None, False),
    ("cuda", torch.float32, "ami", None, False),
    ("cuda", torch.float32, "mem", object(), False),
])
def test_batch_selector_takes_the_kernel_only_for_cuda_float32_mem_alone(device, dtype, scorer,
                                                                         group, fused):
    assert tmi.BatchGreedySelector.takes_kernel(torch.device(device), dtype, scorer,
                                                group) is fused


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_batch_selector_on_the_cpu_runs_the_eager_chain(dtype):
    sel = tmi.BatchGreedySelector(_assignments(), [(0, 1), (2, 3)], C, device="cpu",
                                  dtype=dtype, seed=0)
    assert sel.fused is False and not hasattr(sel, "_out_host")
    picks, gains, _, _ = sel.run_greedy(12, [0])
    assert len(picks) == 12 and all(np.isfinite(gains))
