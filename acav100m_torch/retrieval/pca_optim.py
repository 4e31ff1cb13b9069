"""PCA-projection alignment ranking (the reference's PCAOptim measure).

A copy of ``acav100m_tpu/retrieval/pca_optim.py`` (the port imports nothing of
the JAX package).

Port of ``correspondence_retrieval/code/measures/pca.py:18-125``: project
each view with PCA, score every sample by the mean pairwise
alignment (inner product / cosine / -L1 / -L2) of its projections across
view pairs, and select the top-k. One einsum per distance, in numpy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DISTANCES = {
    "pca": "inner_product",
    "pca_ip": "inner_product",
    "pca_cs": "cosine_similarity",
    "pca_l1": "euclidean_diff_l1",
    "pca_l2": "euclidean_diff_l2",
}


def pca_project(features: np.ndarray, dim: int = 16) -> np.ndarray:
    """(V, D) -> (V, dim) top-principal-component projection."""
    x = features - features.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return (x @ vt[: min(dim, vt.shape[0])].T).astype(np.float32)


def _distance(x1: np.ndarray, x2: np.ndarray, kind: str) -> np.ndarray:
    if kind == "inner_product":
        return np.einsum("vc,vc->v", x1, x2)
    if kind == "cosine_similarity":
        n1 = np.linalg.norm(x1, axis=1)
        n2 = np.linalg.norm(x2, axis=1)
        return np.einsum("vc,vc->v", x1, x2) / np.maximum(n1 * n2, 1e-12)
    if kind == "euclidean_diff_l1":
        return -np.abs(x1 - x2).sum(axis=-1)
    if kind == "euclidean_diff_l2":
        return -((x1 - x2) ** 2).sum(axis=-1)
    raise ValueError(f"invalid distance type {kind}")


def pca_rank_selection(
    projections: Sequence[np.ndarray],
    combinations: Sequence[Tuple[int, int]],
    subset_size: int,
    measure: str = "pca",
) -> Tuple[List[int], List[float]]:
    """Top-``subset_size`` samples by mean pairwise projection alignment
    (reference pca.py run: topk over per-sample distances)."""
    kind = DISTANCES.get(measure, measure)
    scores = None
    for c1, c2 in combinations:
        d = _distance(projections[c1], projections[c2], kind)
        scores = d if scores is None else scores + d
    scores = scores / len(list(combinations))
    order = np.argsort(-scores)[:subset_size]
    gains = np.cumsum(scores[order]).tolist()
    return [int(i) for i in order], gains
