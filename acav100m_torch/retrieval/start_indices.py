"""Greedy start-index strategies.

A copy of ``acav100m_tpu/retrieval/start_indices.py`` (the port imports nothing of
the JAX package).

Port of ``correspondence_retrieval/code/start_indices.py:8-78``: ``zero``
(default singleton), ``random_one_per_class`` (one random sample from each
class block), ``random_uniform_cluster`` (one sample per centroid of the
largest clustering, greedily avoiding centroid collisions in the others).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def get_zero(*args, **kwargs) -> List[int]:
    return [0]


def get_random_one_per_class(nclasses: int, ntargets_per_class: int,
                             rng: np.random.RandomState) -> List[int]:
    return [
        j * ntargets_per_class + int(rng.randint(ntargets_per_class))
        for j in range(nclasses)
    ]


def get_random_uniform_cluster(assignments: np.ndarray,
                               rng: np.random.RandomState) -> List[int]:
    """One start index per centroid of the widest clustering, preferring
    samples whose OTHER clustering assignments land in still-empty
    centroids (reference start_indices.py:28-70)."""
    v, d = assignments.shape
    ncent = [int(assignments[:, j].max()) + 1 for j in range(d)]
    pivot = int(np.argmax(ncent))
    k = ncent[pivot]
    filled = [np.zeros(c, dtype=int) for c in ncent]
    start_indices: List[int] = []
    for cluster_idx in range(k):
        members = np.where(assignments[:, pivot] == cluster_idx)[0]
        if members.size == 0:
            continue
        order = rng.permutation(members)
        pick = order[-1]
        for idx in order:
            ok = True
            for j in range(d):
                if j == pivot:
                    continue
                if filled[j][assignments[idx, j]] > 0:
                    ok = False
                    break
            if ok:
                pick = idx
                break
        start_indices.append(int(pick))
        for j in range(d):
            filled[j][assignments[pick, j]] += 1
    return start_indices


def get_start_indices(option: str, assignments: np.ndarray,
                      nclasses: Optional[int] = None,
                      ntargets_per_class: Optional[int] = None,
                      rng: Optional[np.random.RandomState] = None) -> List[int]:
    rng = rng or np.random.RandomState(0)
    if option == "zero":
        return get_zero()
    if option == "random_one_per_class":
        return get_random_one_per_class(nclasses, ntargets_per_class, rng)
    if option == "random_uniform_cluster":
        return get_random_uniform_cluster(assignments, rng)
    raise ValueError(f"start indices method {option!r} not implemented")
