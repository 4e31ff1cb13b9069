"""Clustering frontends for retrieval experiments.

Counterpart of ``acav100m_tpu/retrieval/clustering.py``, the port of
``correspondence_retrieval/code/clustering.py:13-116`` + ``pca.py``: whiten
features, then cluster per (view, layer) with a pluggable algorithm:

* ``sgd`` — the stage-5 mini-batch k-means of ``ops.kmeans`` on ``device``,
  whose post-warmup steps launch kernel K1 on a CUDA device;
* ``scipy`` — ``scipy.cluster.vq.kmeans2``;
* ``sklearn`` — Lloyd's (stands in for the faiss-gpu frontend; same
  algorithm, no GPU library); scikit-learn is imported only here;
* ``pca`` — top principal component split into ``ncentroids`` quantile
  buckets.

Everything but ``sgd_kmeans`` is a copy of the JAX module; the frontends
take ``device=``, which only ``sgd`` uses.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kmeans


def whiten(features: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Per-dim standardization (scipy.cluster.vq.whiten semantics)."""
    std = features.std(axis=0)
    return features / np.maximum(std, eps)


class Clustering:
    """Fitted clustering: ``assign`` maps features -> centroid ids, plus
    the reference's ind2cen/cen2ind-style bookkeeping."""

    def __init__(self, centers: np.ndarray, assignments: np.ndarray):
        self.centers = centers
        self.assignments = assignments  # train-set assignments
        self.ncentroids = centers.shape[0]

    def assign(self, features: np.ndarray) -> np.ndarray:
        d = (
            -2.0 * features @ self.centers.T
            + (features ** 2).sum(-1, keepdims=True)
            + (self.centers ** 2).sum(-1)[None]
        )
        return d.argmin(axis=1)

    def get_assignment(self, idx: int) -> int:
        return int(self.assignments[idx])


def sgd_kmeans(features: np.ndarray, ncentroids: int, seed: int = 0,
               epochs: int = 20, batch_size: int = 64, device=None,
               init_centers: Optional[np.ndarray] = None,
               warmup_draws: Optional[Sequence[np.ndarray]] = None) -> Clustering:
    """Single-view SGD k-means through ``ops.kmeans`` on ``device``.

    The JAX package's loop (``correspondence_retrieval/code/
    sgd_clustering.py:29-46`` defaults): 20 epochs of batch-64 updates in
    a ``RandomState(seed)`` permutation, lr ``0.1**(2+epoch//5)``, every
    sample seen each epoch (the tail batch runs at its own shape).

    The initial ``rand * 1e-5`` centers and the warmup steps' random
    assignments are drawn from a CPU ``torch.Generator`` seeded with
    ``seed``. ``init_centers`` (K, D) replaces the first, and
    ``warmup_draws[i]`` (1, K, rows of step i) the draws of step i, so a
    caller can replay another implementation's draws; steps past the end
    of ``warmup_draws`` draw from the generator.

    Kernel K1 takes widths in multiples of 4 and at least 4, so the rows
    are padded with zero columns to the next multiple of 4 and K1 is told
    the real width (``dims``): it skips the padding, and the assignments
    and centers are those of the unpadded input."""
    device = resolve_device(device)
    v, d = features.shape
    dmax = max(4, -(-d // 4) * 4)
    gen = torch.Generator().manual_seed(seed)
    centers = None
    if init_centers is not None:
        centers = kmeans.pad_features(
            np.asarray(init_centers, np.float32).reshape(1, ncentroids, d), dmax)
    state = kmeans.init_state([d], ncentroids, dmax, generator=gen,
                              centers=centers, device=device)
    x = torch.as_tensor(kmeans.pad_features(np.asarray(features, np.float32), dmax),
                        device=device)
    rng = np.random.RandomState(seed)
    step = 0
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(v), device=device)
        lr = kmeans.lr_schedule(epoch)
        for i in range(0, v, batch_size):
            rand = None
            if warmup_draws is not None and step < len(warmup_draws):
                rand = torch.tensor(np.asarray(warmup_draws[step], np.float32))
            batch = x[order[i : i + batch_size]][None]
            state, _ = kmeans.train_step(state, batch, lr, rand=rand, generator=gen)
            step += 1
    centers = state.centers[0, :, :d].cpu().numpy()
    assignments = kmeans.assign_step(state, x[None])[0].cpu().numpy()
    return Clustering(centers, assignments.astype(np.int32))


def scipy_kmeans(features: np.ndarray, ncentroids: int, seed: int = 0,
                 device=None) -> Clustering:
    from scipy.cluster.vq import kmeans2

    centers, labels = kmeans2(
        features.astype(np.float64), ncentroids, minit="++", seed=seed
    )
    return Clustering(centers.astype(np.float32), labels)


def sklearn_kmeans(features: np.ndarray, ncentroids: int, seed: int = 0,
                   device=None) -> Clustering:
    from sklearn.cluster import KMeans as SkKMeans

    km = SkKMeans(n_clusters=ncentroids, random_state=seed, n_init=3).fit(features)
    return Clustering(km.cluster_centers_.astype(np.float32), km.labels_)


def pca_clustering(features: np.ndarray, ncentroids: int, seed: int = 0,
                   device=None) -> Clustering:
    """Bucket by the top principal component (reference pca.py:6-20)."""
    x = features - features.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[0]
    edges = np.quantile(proj, np.linspace(0, 1, ncentroids + 1)[1:-1])
    labels = np.searchsorted(edges, proj)
    centers = np.stack(
        [
            features[labels == c].mean(axis=0)
            if np.any(labels == c)
            else features.mean(axis=0)
            for c in range(ncentroids)
        ]
    )
    return Clustering(centers.astype(np.float32), labels)


_FRONTENDS = {
    "sgd": sgd_kmeans,
    "scipy": scipy_kmeans,
    "sklearn": sklearn_kmeans,
    "faiss": sklearn_kmeans,  # faiss-gpu stand-in: same Lloyd's algorithm
    "pca": pca_clustering,
}


def cluster_views(
    view_features: Dict[str, np.ndarray],
    ncentroids: int,
    method: str = "sgd",
    seed: int = 0,
    do_whiten: bool = True,
    device=None,
) -> Dict[str, Clustering]:
    """Cluster every (view, layer) feature matrix -> {view: Clustering}."""
    fn = _FRONTENDS[method]
    out = {}
    for i, (view, feats) in enumerate(sorted(view_features.items())):
        feats = np.asarray(feats, dtype=np.float32)
        if do_whiten:
            feats = whiten(feats)
        out[view] = fn(feats, ncentroids, seed=seed + i, device=device)
    return out


def assignments_matrix(clusterings: Dict[str, "Clustering"]) -> np.ndarray:
    """(V, D) assignment matrix over sorted view keys."""
    keys = sorted(clusterings)
    return np.stack([clusterings[k].assignments for k in keys], axis=1)
