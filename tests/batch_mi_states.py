"""Seeded states of stage 6's batched greedy step, for the tests of the
fused step (``mi.batch_mi_step``) and its plain twin: ten clusterings of
a pool at K=32 drawn from latent classes (so winners often share cells),
45 pairs, a batch of 20 and k=4, as in stage 6's settings.

``state(name, device)`` -> (cache, stats, pairs_all, ids, valid, k,
weights) with

* ``empty``: the eps-filled cache;
* ``after_200``: 200 clips of the pool folded in;
* ``tail``: that cache and a tail batch of 3 real candidates and 17 pads
  (fewer than k, so a pad is among the winners, folded with weight 0);
* ``weighted``: that cache with pair weights.

``parity_assignments`` and ``PARITY`` are the small pool on which the
port's selector is held against the JAX package's
(``tests/test_torch_mi.py``), and whose JAX run is recorded in
``tests/data/batch_greedy_jax.npz`` for the card
(``python -m tests.gen_batch_greedy_jax`` writes it).
"""

from itertools import combinations
from pathlib import Path

import numpy as np
import torch

from acav100m_torch.ops import mi

D, C, V, B, K = 10, 32, 2000, 20, 4
STATES = ("empty", "after_200", "tail", "weighted")
COMBOS = list(combinations(range(D), 2))


def assignments(seed: int, v: int = V, classes: int = 32) -> np.ndarray:
    """(v, D) cluster ids: each clip's class through a fixed random map a
    clustering, half the clips with another class for clusterings 5-9,
    every id redrawn with probability 0.25."""
    rng = np.random.RandomState(seed)
    maps = np.stack([rng.permutation(C) for _ in range(D)])
    cls_a = rng.randint(0, classes, v)
    cls_v = np.where(rng.rand(v) < 0.5, cls_a, rng.randint(0, classes, v))
    cls = np.where(np.arange(D)[None, :] < 5, cls_a[:, None], cls_v[:, None])
    a = maps[np.arange(D)[None, :], cls % C]
    return np.where(rng.rand(v, D) < 0.25, rng.randint(0, C, (v, D)), a)


# the JAX parity pool: V 200, 10 clusterings at K=8 (45 pairs), B 20, k 4,
# the cache seeded with the first 20 rows, a subset of 60, the pool's
# RandomState(1)
PARITY = dict(v=200, d=10, c=8, batch_size=20, selection_size=4, start=list(range(20)),
              subset=60, rng_seed=1)
JAX_RECORD = Path(__file__).parent / "data" / "batch_greedy_jax.npz"


def record_key(keep_unselected: bool, name: str) -> str:
    """The name of one array of ``JAX_RECORD``."""
    return f"keep{int(keep_unselected)}_{name}"


def parity_assignments(seed: int = 0) -> np.ndarray:
    """(200, 10) cluster ids at K=8 with duplicated rows, which score
    exactly alike (exact ties, which go to the lowest index)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, PARITY["c"], (PARITY["v"], PARITY["d"]))
    a[150:180] = a[60:90]
    a[180:200] = a[60]
    return a


def state(name: str, device, seed: int = 0):
    pairs_all = torch.as_tensor(mi.pair_assignments(assignments(seed), COMBOS), device=device)
    rng = np.random.RandomState(seed + 1)
    cache = mi.init_cache(len(COMBOS), C, torch.float32, device)
    if name != "empty":
        folded = torch.as_tensor(rng.choice(V, 200, replace=False), device=device)
        cache = mi.add_candidates_to_cache(cache, pairs_all[folded], C)
    ids = rng.choice(V, B, replace=False).astype(np.int64)
    valid = B
    if name == "tail":
        valid = 3
        ids[valid:] = ids[0]
    weights = None
    if name == "weighted":
        weights = torch.as_tensor(rng.uniform(0.2, 2.0, len(COMBOS)).astype(np.float32),
                                  device=device)
    return cache, mi.mem_stats(cache), pairs_all, ids, valid, K, weights
