"""Oracle measures for the retrieval experiments.

A copy of ``acav100m_tpu/retrieval/measures.py`` (the port imports nothing of
the JAX package).

These are the slow, obviously-correct implementations the efficient
device-side measures (``ops.mi``) are validated against — the reference's
own test pattern (SURVEY.md section 4): naive agreement counting
(``measures/custom_measure.py``), sklearn mutual information
(``measures/mutual_information.py``), and a constant null measure.

All operate on an (V, D) assignment matrix + a list of clustering pairs and
expose ``score(indices) -> float`` over a candidate subset.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OracleMeasure:
    def __init__(self, assignments: np.ndarray, pairs: Sequence[Tuple[int, int]]):
        self.assignments = np.asarray(assignments)
        self.pairs = list(pairs)

    def score(self, indices: Sequence[int]) -> float:
        raise NotImplementedError


class SklearnMIMeasure(OracleMeasure):
    """Mean sklearn ``mutual_info_score`` over pairs
    (reference mutual_information.py:11-104)."""

    def __init__(self, assignments, pairs, kind: str = "mi",
                 average_method: str = "arithmetic"):
        super().__init__(assignments, pairs)
        self.kind = kind
        self.average_method = average_method

    def _pair_score(self, x, y) -> float:
        """One sklearn score — the reference's MEASURES table
        (mutual_information.py:11-17): mutual_info / adjusted_mutual_info /
        normalized_mutual_info / fowlkes_mallows / adjusted_rand."""
        from sklearn import metrics

        if self.kind == "mi":
            return metrics.mutual_info_score(x, y)
        if self.kind == "nmi":
            return metrics.normalized_mutual_info_score(
                x, y, average_method=self.average_method)
        if self.kind == "ami":
            return metrics.adjusted_mutual_info_score(
                x, y, average_method=self.average_method)
        if self.kind == "fm":
            return metrics.fowlkes_mallows_score(x, y)
        if self.kind == "arand":
            return metrics.adjusted_rand_score(x, y)
        raise ValueError(self.kind)

    def score(self, indices: Sequence[int]) -> float:
        idx = list(indices)
        if len(idx) < 2:
            return 0.0
        sub = self.assignments[idx]
        return float(np.mean(
            [self._pair_score(sub[:, a], sub[:, b]) for a, b in self.pairs]
        ))


class AgreementMeasure(OracleMeasure):
    """Agreed-pair counting (reference custom_measure.py:8-99): for each
    clustering pair, count index pairs assigned together by BOTH
    clusterings, normalized by each clustering's total agreed pairs."""

    def __init__(self, assignments, pairs):
        super().__init__(assignments, pairs)
        v = self.assignments.shape[0]
        self.total_agreed = []
        for d in range(self.assignments.shape[1]):
            col = self.assignments[:, d]
            same = col[:, None] == col[None, :]
            self.total_agreed.append(max((same.sum() - v) / 2.0, 1.0))

    def score(self, indices: Sequence[int]) -> float:
        idx = list(indices)
        if len(idx) < 2:
            return 0.0
        sub = self.assignments[idx]
        measures = []
        for a, b in self.pairs:
            both = 0
            for i, j in combinations(range(len(idx)), 2):
                if sub[i, a] == sub[j, a] and sub[i, b] == sub[j, b]:
                    both += 1
            measures.append(
                (both / self.total_agreed[a] + both / self.total_agreed[b]) / 2.0
            )
        return float(np.mean(measures))


class ConstantMeasure(OracleMeasure):
    """Null-hypothesis baseline (reference measures/efficient.py:370-380)."""

    def score(self, indices: Sequence[int]) -> float:
        return 1.0


def get_oracle_measure(name: str, assignments, pairs) -> OracleMeasure:
    if name in ("mi", "nmi", "ami", "fm", "arand"):
        return SklearnMIMeasure(assignments, pairs, kind=name)
    if name == "agreement":
        return AgreementMeasure(assignments, pairs)
    if name == "constant":
        return ConstantMeasure(assignments, pairs)
    raise ValueError(f"unknown oracle measure {name!r}")
