"""Stage 6's other measures: the port's full-table scorers, ``GreedySelector``,
``BatchGreedySelector``'s ``scorer`` option, ``compare_measures`` and
``compare_dtypes`` against the JAX package's on the same seeded inputs.

Scorers are compared on an eps-filled cache with 30 samples folded in. In
float64 the port's scores are held within 1e-10 of the JAX package's,
relative to the largest |score|. In float32 the port's error against JAX's
float64 scores must be at most twice JAX's own float32 error plus 1e-6.

Greedy runs fold 16 start samples, and the fixture seed is one on which no
pick of a run is a tie that rounding decides: a cache that holds a single
sample makes many distinct candidates tie exactly (ROADMAP.md, "How parity
is checked")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.ops import mi as jmi
from acav100m_tpu.pipeline import subset_selection as jss
from acav100m_tpu.utils.io import dump_pickle
from acav100m_torch.ops import mi as tmi
from acav100m_torch.ops.pairing import get_cluster_pairing
from acav100m_torch.pipeline import subset_selection as tss

torch.set_num_threads(1)

V, D, C = 120, 5, 6
KINDS = ["mi", "ami", "nmi", "constant", "fm", "rand", "arand", "emi"]
AVERAGES = ["arithmetic", "max", "min"]


def _problem(seed=0, v=V, d=D, c=C):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, c, (v, d))
    combos = get_cluster_pairing([(str(i), "x") for i in range(d)], "combination")
    return a, combos


def _pair_weights(n):
    return np.random.RandomState(7).uniform(0.1, 1.0, n).astype(np.float32)


def _jax_scores(kind, avg, weights, dtype, pairs):
    """JAX package's scores of candidates 30.. on a cache holding 0..29."""
    jdt = {"float32": jnp.float32, "float64": jnp.float64}[dtype]
    with jax.enable_x64(dtype == "float64"):
        cache = jmi.init_cache(pairs.shape[1], C, jdt)
        cache = jmi.add_candidates_to_cache(cache, jnp.asarray(pairs[:30]), C)
        cand = jnp.asarray(pairs[30:])
        if kind == "emi":
            tables = jmi.candidate_tables(cand, C, jdt)
            last = {k: cache[k][None] + tables[k] for k in cache}
            return np.asarray(jmi._pair_mean(jmi.calc_emi(last), weights), np.float64)
        return np.asarray(jmi.score_candidates_full(cache, cand, C, kind, avg, weights),
                          np.float64)


def _torch_scores(kind, avg, weights, dtype, pairs):
    tdt = getattr(torch, dtype)
    cache = tmi.init_cache(pairs.shape[1], C, tdt)
    cache = tmi.add_candidates_to_cache(cache, torch.from_numpy(pairs[:30]), C)
    cand = torch.from_numpy(pairs[30:])
    if kind == "emi":
        tables = tmi.candidate_tables(cand, C, tdt)
        last = {k: cache[k][None] + tables[k] for k in cache}
        return tmi._pair_mean(tmi.calc_emi(last), weights).double().numpy()
    return tmi.score_candidates_full(cache, cand, C, kind, avg, weights).double().numpy()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("avg", AVERAGES)
@pytest.mark.parametrize("kind", KINDS)
def test_full_scores_match_jax(kind, avg, weighted):
    a, combos = _problem()
    pairs = tmi.pair_assignments(a, combos)
    weights = _pair_weights(len(combos)) if weighted else None
    j64 = _jax_scores(kind, avg, weights, "float64", pairs)
    j32 = _jax_scores(kind, avg, weights, "float32", pairs)
    t64 = _torch_scores(kind, avg, weights, "float64", pairs)
    t32 = _torch_scores(kind, avg, weights, "float32", pairs)
    scale = np.abs(j64).max()
    assert np.isfinite(t64).all() and scale > 0
    assert np.abs(t64 - j64).max() <= 1e-10 * scale
    jax_err = np.abs(j32 - j64).max() / scale
    assert np.abs(t32 - j64).max() / scale <= 2 * jax_err + 1e-6


def test_candidate_tables_match_jax():
    a, combos = _problem(1)
    pairs = tmi.pair_assignments(a, combos)[:10]
    jt = jmi.candidate_tables(jnp.asarray(pairs), C, jnp.float32)
    tt = tmi.candidate_tables(torch.from_numpy(pairs), C, torch.float32)
    for key in ("N", "a", "b", "n"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]))


def test_weighted_scores_differ_and_mem_equals_full_mi():
    a, combos = _problem(2, v=40)
    plain = tmi.GreedySelector(a, combos, ncentroids=C, dtype="float64", device="cpu")
    w = np.zeros(len(combos), np.float32)
    w[0] = 1.0
    weighted = tmi.GreedySelector(a, combos, ncentroids=C, pair_weights=w,
                                  dtype="float64", device="cpu")
    full = tmi.GreedySelector(a, combos, ncentroids=C, scorer="full",
                              dtype="float64", device="cpu")
    for sel in (plain, weighted, full):
        sel.add_samples([0, 1, 2])
    assert not np.allclose(plain.scores(), weighted.scores())
    np.testing.assert_allclose(plain.scores(), full.scores(), rtol=1e-12, atol=1e-12)


# the seed of the greedy runs: none of their picks is a rounding tie
GREEDY_SEED = 0
START = list(range(16))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-5)])
@pytest.mark.parametrize("kind,scorer", [("mi", "mem"), ("mi", "full"), ("ami", "full"),
                                         ("nmi", "full")])
def test_greedy_selector_matches_jax(kind, scorer, dtype, tol):
    a, combos = _problem(GREEDY_SEED, v=80, d=4, c=8)
    kwargs = dict(ncentroids=8, kind=kind, scorer=scorer, dtype=dtype)
    js = jmi.GreedySelector(a, combos, **kwargs)
    ts = tmi.GreedySelector(a, combos, device="cpu", **kwargs)
    jsel, jgain, _, _ = js.run_greedy(36, START)
    tsel, tgain, _, _ = ts.run_greedy(36, START)
    assert len(tsel) == 35 and tsel[:16] == START
    assert tsel == jsel
    np.testing.assert_allclose(tgain, jgain, rtol=tol, atol=tol)


def test_mem_and_full_mi_pick_alike_in_the_port():
    a, combos = _problem(GREEDY_SEED, v=80, d=4, c=8)
    mem = tmi.GreedySelector(a, combos, ncentroids=8, scorer="mem", dtype="float64",
                             device="cpu")
    full = tmi.GreedySelector(a, combos, ncentroids=8, scorer="full", dtype="float64",
                              device="cpu")
    s_mem, g_mem, _, _ = mem.run_greedy(40, START)
    s_full, g_full, _, _ = full.run_greedy(40, START)
    assert s_mem == s_full
    np.testing.assert_allclose(g_mem, g_full, rtol=1e-10, atol=1e-12)


def test_greedy_selector_without_fold_keeps_an_empty_cache():
    a, combos = _problem(3, v=30, d=4, c=8)
    ts = tmi.GreedySelector(a, combos, ncentroids=8, dtype="float64", device="cpu")
    sel, _, _, _ = ts.run_greedy(5, [7], fold_start=False)
    # the singleton takes an output slot only; the mem scorer's first pick
    # is the first active index, every score tying exactly
    assert sel[:2] == [7, 0] and len(sel) == 4
    assert float(ts.cache["n"][0]) == pytest.approx(3 + 64 * tmi.EPS)


def test_greedy_selector_refusals():
    a, combos = _problem(3, v=30, d=4, c=8)
    with pytest.raises(ValueError):
        tmi.GreedySelector(a, combos, ncentroids=8, kind="ami", scorer="mem")
    with pytest.raises(ValueError):
        tmi.GreedySelector(a, combos, ncentroids=8, kind="nope")
    with pytest.raises(ValueError):
        tmi.BatchGreedySelector(a, combos, ncentroids=8, scorer="nope")


@pytest.mark.parametrize("scorer", ["ami", "nmi"])
def test_batch_greedy_full_scorer_matches_jax(scorer):
    a, combos = _problem(4, v=150, d=4, c=8)
    kwargs = dict(ncentroids=8, batch_size=20, selection_size=4, scorer=scorer,
                  dtype="float64")
    js = jmi.BatchGreedySelector(a, combos, rng=np.random.RandomState(1), **kwargs)
    ts = tmi.BatchGreedySelector(a, combos, rng=np.random.RandomState(1), device="cpu",
                                 **kwargs)
    start = list(range(10))
    jsel, jgain, _, _ = js.run_greedy(40, start)
    tsel, tgain, _, _ = ts.run_greedy(40, start)
    assert tsel == jsel
    np.testing.assert_allclose(tgain, jgain, rtol=1e-10, atol=1e-12)


def _write_partition(root, seed=4, n=30):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        assign = {f"layer_{j}": int(rng.randint(4)) for j in range(3)}
        rows.append({"filename": f"c{i}.mp4", "shard_name": "shard-000000",
                     "shard_size": n,
                     "video_assignments": [{"model_key": "m", "array": assign}],
                     "audio_assignments": []})
    dump_pickle(rows, root / "shard-000000.pkl")


@pytest.mark.parametrize("measures", [("mi", "mem_mi"), ("ami", "nmi"), ("mi", "ami")])
def test_compare_measures_matches_jax(tmp_path, measures):
    _write_partition(tmp_path)  # a seed whose picks hang on no rounding tie
    over = {"data.path": str(tmp_path / "shard-000000.pkl"), "subset.size": 10}
    jrep = jss.compare_measures(jss.get_config(over), measures)
    trep = tss.compare_measures(tss.get_config({**over, "computation.device": "cpu"}),
                                measures)
    assert trep.keys() == jrep.keys()
    assert trep["partitions"].keys() == jrep["partitions"].keys()
    for pid, jpart in jrep["partitions"].items():
        tpart = trep["partitions"][pid]
        assert tpart.keys() == jpart.keys()
        assert tpart["subset_size"] == jpart["subset_size"]
        assert tpart["selection_equal_ratio"] == jpart["selection_equal_ratio"]
        assert abs(tpart["max_gain_diff"] - jpart["max_gain_diff"]) <= 1e-6


def test_compare_dtypes_matches_jax():
    # a seed on which neither run's picks hang on a rounding tie
    a, combos = _problem(0, v=400, d=4, c=8)
    kwargs = dict(ncentroids=8, subset_size=80, batch_size=32, selection_size=4,
                  keep_unselected=False)
    jrep = jss.compare_dtypes(a, combos, **kwargs)
    trep = tss.compare_dtypes(a, combos, device="cpu", **kwargs)
    assert trep.keys() == jrep.keys()
    for key in ("rounds", "flip_rounds", "subset_size"):
        assert trep[key] == jrep[key]
    for key in ("flip_rate", "subset_overlap", "positionwise_equal", "max_gain_diff"):
        assert abs(trep[key] - jrep[key]) <= 1e-6


def test_compare_defaults_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _write_partition(tmp_path)
    a, combos = _problem(5, v=20, d=3, c=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tss.compare_measures(tss.get_config({"data.path": str(tmp_path / "shard-000000.pkl")}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tss.compare_dtypes(a, combos, ncentroids=4, subset_size=5)


def test_selector_defaults_raise_without_cuda():
    """The selectors resolve their default device as every entry point does:
    ``cuda``, raising where there is no card, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    a, combos = _problem(5, v=20, d=3, c=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmi.GreedySelector(a, combos, ncentroids=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmi.BatchGreedySelector(a, combos, ncentroids=4)
