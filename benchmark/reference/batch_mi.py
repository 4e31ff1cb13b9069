"""Plain batched greedy MI selection: the benchmark's reference for stage 6.

ACAV100M's ``subset_selection/code/measures/batch.py`` (``EfficientBatchMI``)
with its pool bookkeeping, in float64 NumPy: the contingency cache of every
cluster pair, eps-filled; each iteration shuffles the remaining pool with
the run's ``RandomState``, scores the first ``B`` candidates as if each
were added alone (the pairs' mean mutual information of the cache plus
the candidate), takes the ``k`` best, folds them into the cache and puts
the rest back at the end of the pool in sorted order (``np.setdiff1d``).
The start candidate (the first of a shuffled pool) only seeds the cache.

``replay`` follows the program's own picks (teacher forcing): at each
iteration it scores the batch itself and reports how far the program's
picks lie below its own k-th best score, so a pick that rounding decides
between equal candidates costs nothing and a wrong pick shows. It imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

EPS = float(np.finfo(np.float64).eps)


def nlogn(x: np.ndarray) -> np.ndarray:
    return x * np.log(x)


class Cache:
    def __init__(self, pairs: int, c: int):
        self.n_mat = np.full((pairs, c, c), EPS)
        self.a = self.n_mat.sum(1)  # indexed by the second view
        self.b = self.n_mat.sum(2)  # indexed by the first view
        self.n = self.a.sum(-1)
        self.pidx = np.arange(pairs)

    def scores(self, cand: np.ndarray) -> np.ndarray:
        """(W, P, 2) pair coordinates -> (W,) mean MI after adding each."""
        i1, i2 = cand[..., 0], cand[..., 1]
        nn, a, b = self.n_mat[self.pidx, i1, i2], self.a[self.pidx, i2], self.b[self.pidx, i1]
        s_n = nlogn(self.n_mat).sum((1, 2)) - nlogn(nn) + nlogn(nn + 1)
        s_a = nlogn(self.a).sum(1) - nlogn(a) + nlogn(a + 1)
        s_b = nlogn(self.b).sum(1) - nlogn(b) + nlogn(b + 1)
        n1 = self.n + 1
        return ((s_n - s_a - s_b) / n1 + np.log(n1)).mean(-1)

    def add(self, cand: np.ndarray) -> None:
        for one in cand:
            self.n_mat[self.pidx, one[:, 0], one[:, 1]] += 1
            self.a[self.pidx, one[:, 1]] += 1
            self.b[self.pidx, one[:, 0]] += 1
            self.n += 1


def pair_coordinates(assignments: np.ndarray, combos: Sequence[Tuple[int, int]]) -> np.ndarray:
    comb = np.asarray(combos)
    return np.stack([assignments[:, comb[:, 0]], assignments[:, comb[:, 1]]], -1)


def replay(assignments: np.ndarray, combos, c: int, subset: int, batch: int, k: int,
           seed: int, picks: Sequence[int], gains: Sequence[float]) -> Dict[str, float]:
    """Follow ``picks`` (the program's, in order) through the pool's
    iterations; -> {pick_gap, gain_err, foreign} where ``foreign`` counts
    picks not in their iteration's batch."""
    pairs = pair_coordinates(assignments, combos)
    v = assignments.shape[0]
    rng = np.random.RandomState(seed)
    order = np.arange(v)
    rng.shuffle(order)
    start = int(order[0])
    cache = Cache(len(combos), c)
    cache.add(pairs[[start]])
    ids = np.arange(v)
    ids = ids[ids != start]
    gap = err = 0.0
    foreign = 0
    picks = np.asarray(picks, dtype=np.int64)
    pos = 0
    while pos < min(subset, len(picks)):
        rng.shuffle(ids)
        b = min(batch, len(ids))
        cand = ids[:b]
        scores = cache.scores(pairs[cand])
        mine = picks[pos:pos + k]
        where = {int(x): j for j, x in enumerate(cand)}
        idx = [where.get(int(x)) for x in mine]
        if any(j is None for j in idx):
            foreign += sum(j is None for j in idx)
            break
        kth = np.sort(scores)[::-1][min(k, b) - 1]
        # nan_to_num: a NaN score or gain would pass any limit
        gap = max(gap, float(np.nan_to_num((kth - scores[idx]).max(), nan=np.inf)))
        err = max(err, float(np.nan_to_num(
            np.abs(np.asarray(gains[pos:pos + len(idx)]) - scores[idx]).max(), nan=np.inf)))
        winners = picks[pos:pos + k]
        cache.add(pairs[winners])
        ids = np.concatenate([ids[b:], np.setdiff1d(cand, winners)])
        pos += k
    return {"pick_gap": gap, "gain_err": err, "foreign": float(foreign)}
