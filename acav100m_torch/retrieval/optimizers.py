"""Subset-selection optimizers for the retrieval experiments.

Port of ``correspondence_retrieval/code/optimization/``:

* ``greedy`` — naive O(V^2) rescoring with an oracle measure
  (optimization/greedy.py:10-71);
* ``celf`` — lazy greedy exploiting submodularity (optimization/celf.py);
* ``efficient_greedy`` — the production device-side greedy
  (ops.mi.GreedySelector; optimization/efficient.py + measures/efficient.py);
* ``efficient_batch`` — batch-greedy (ops.mi.BatchGreedySelector).

Counterpart of ``acav100m_tpu/retrieval/optimizers.py``: the same
functions, with ``device=`` passed to the selectors (which default to
``cuda`` and raise without a card).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.mi import BatchGreedySelector, GreedySelector
from .measures import OracleMeasure


def naive_greedy(measure: OracleMeasure, dataset_size: int, subset_size: int,
                 start_indices: Sequence[int] = (0,)) -> Tuple[List[int], List[float]]:
    selected = list(start_indices)
    gains: List[float] = []
    candidates = [i for i in range(dataset_size) if i not in set(selected)]
    while len(selected) < subset_size:
        best_score, best_idx = -np.inf, None
        for c in candidates:
            s = measure.score(selected + [c])
            if s > best_score:
                best_score, best_idx = s, c
        selected.append(best_idx)
        candidates.remove(best_idx)
        gains.append(best_score)
    return selected, gains


def celf(measure: OracleMeasure, dataset_size: int, subset_size: int,
         start_indices: Sequence[int] = (0,)) -> Tuple[List[int], List[float]]:
    """Lazy greedy: re-evaluate only the top of a max-heap of stale marginal
    gains (reference optimization/celf.py:6-77)."""
    selected = list(start_indices)
    base = measure.score(selected)
    heap: List[Tuple[float, int]] = []
    for c in range(dataset_size):
        if c in set(selected):
            continue
        gain = measure.score(selected + [c]) - base
        heap.append((-gain, c))
    heapq.heapify(heap)
    gains: List[float] = []
    while len(selected) < subset_size and heap:
        while True:
            neg_gain, c = heapq.heappop(heap)
            fresh = measure.score(selected + [c]) - base
            if not heap or fresh >= -heap[0][0] - 1e-12:
                selected.append(c)
                base = base + fresh
                gains.append(base)
                break
            heapq.heappush(heap, (-fresh, c))
    return selected, gains


def efficient_greedy(assignments: np.ndarray, pairs, ncentroids: int,
                     subset_size: int, start_indices: Sequence[int] = (0,),
                     kind: str = "mi", device=None) -> Tuple[List[int], List[float]]:
    sel = GreedySelector(assignments, pairs, ncentroids=ncentroids, kind=kind,
                         device=device)
    # GreedySelector stops at subset_size-1 like the reference loop; ask for
    # one extra so callers get exactly subset_size
    subset, gains, _, _ = sel.run_greedy(subset_size + 1, list(start_indices))
    return subset[:subset_size], gains


def efficient_batch(assignments: np.ndarray, pairs, ncentroids: int,
                    subset_size: int, start_indices: Sequence[int] = (0,),
                    batch_size: int = 20, selection_size: int = 4,
                    seed: int = 0, device=None) -> Tuple[List[int], List[float]]:
    sel = BatchGreedySelector(
        assignments, pairs, ncentroids=ncentroids, batch_size=batch_size,
        selection_size=selection_size, keep_unselected=True, seed=seed,
        device=device,
    )
    subset, gains, _, _ = sel.run_greedy(subset_size, list(start_indices))
    return list(start_indices) + subset, gains


OPTIMIZERS = {
    "greedy": naive_greedy,
    "celf": celf,
    "efficient_greedy": efficient_greedy,
    "efficient_batch": efficient_batch,
}
