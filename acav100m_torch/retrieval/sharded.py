"""Sharded derangement experiments: separate vs shared clustering.

Port of ``correspondence_retrieval/code/{sharded_derangement.py,
compare_shards.py:11-107}``: split the deranged dataset into shards and
compare selection quality when each shard is clustered independently
(the production pipeline's per-partition regime) versus when one clustering
is fit on the full dataset — quantifying the cost of shard-local centroids.

Counterpart of ``acav100m_tpu/retrieval/sharded.py``: the same functions,
with clustering and selection on ``device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..ops.pairing import get_cluster_pairing
from .clustering import cluster_views, whiten
from .derangement import derange_views, precision_recall_f1
from .optimizers import efficient_greedy


def shard_split(dataset_size: int, num_shards: int,
                rng: Optional[np.random.RandomState] = None,
                method: str = "random") -> List[np.ndarray]:
    """Disjoint shards covering the dataset.

    ``random`` (default): random membership via one permutation.
    ``contiguous``: the reference's live slicing — equal ``size//n``
    shards with the remainder folded into the LAST shard
    (``sharded_derangement.py::get_shards``, oracle-tested)."""
    if method == "contiguous":
        size = dataset_size // num_shards
        sizes = [size] * num_shards
        sizes[-1] += dataset_size % num_shards
        starts = np.cumsum([0] + sizes[:-1])
        return [np.arange(s, s + n) for s, n in zip(starts, sizes)]
    if method != "random":
        raise ValueError(f"unknown shard split method {method!r}")
    order = (rng or np.random.RandomState(0)).permutation(dataset_size)
    return [np.sort(part) for part in np.array_split(order, num_shards)]


def run_sharded_experiment(
    views: Dict,
    num_shards: int = 2,
    shared_clustering: bool = False,
    deranged_classes_ratio: float = 0.5,
    ncentroids: int = 8,
    clustering_method: str = "sklearn",
    measure: str = "mi",
    shard_method: str = "random",
    seed: int = 0,
    device=None,
) -> Dict:
    """Returns per-shard precision/recall plus the micro-averaged scores."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    der = derange_views(views, deranged_classes_ratio, rng=rng)
    feats = {
        view: np.stack([d["data"] for d in rows])
        for view, rows in der["features"].items()
    }
    keys = [tuple(k.split("-", 1)) for k in sorted(feats)]
    pairs = get_cluster_pairing(keys, "combination")
    shards = shard_split(der["dataset_size"], num_shards, rng,
                         method=shard_method)
    true_ids = set(der["true_ids"])

    if shared_clustering:
        clusterings = cluster_views(feats, ncentroids, method=clustering_method,
                                    seed=seed, device=device)

    all_selected: List[int] = []
    per_shard = []
    for shard in shards:
        shard_feats = {v: f[shard] for v, f in feats.items()}
        if shared_clustering:
            # assign shard rows with the global centroids
            assignments = np.stack(
                [
                    clusterings[v].assign(whiten(feats[v])[shard])
                    for v in sorted(shard_feats)
                ],
                axis=1,
            )
        else:
            local = cluster_views(shard_feats, ncentroids,
                                  method=clustering_method, seed=seed,
                                  device=device)
            assignments = np.stack(
                [local[v].assignments for v in sorted(local)], axis=1
            )
        shard_true = [i for i, g in enumerate(shard) if g in true_ids]
        subset_size = max(len(shard_true), 1)
        order, _ = efficient_greedy(
            assignments, pairs, ncentroids, subset_size, [0], kind=measure,
            device=device,
        )
        selected_global = [int(shard[i]) for i in order[:subset_size]]
        all_selected.extend(selected_global)
        p, r, f1 = precision_recall_f1(order[:subset_size], shard_true)
        per_shard.append({"precision": p, "recall": r, "f1": f1,
                          "shard_size": len(shard)})

    p, r, f1 = precision_recall_f1(all_selected, der["true_ids"])
    return {
        "shared_clustering": shared_clustering,
        "num_shards": num_shards,
        "per_shard": per_shard,
        "precision": p,
        "recall": r,
        "f1": f1,
    }


def compare_shards(views: Dict, num_shards: int = 2, **kwargs) -> Dict:
    """Separate-vs-shared comparison (reference compare_shards.py)."""
    separate = run_sharded_experiment(views, num_shards,
                                      shared_clustering=False, **kwargs)
    shared = run_sharded_experiment(views, num_shards,
                                    shared_clustering=True, **kwargs)
    return {"separate": separate, "shared": shared}
