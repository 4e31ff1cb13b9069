"""Cluster pairings: which clusterings are compared by the MI measure.

Port of ``subset_selection/code/pairing.py:5-41``. ``keys`` are clustering
type identifiers, e.g. ``(view, layer)`` tuples or
``"{extractor_name}/{dataset}"``-style strings; the default production
pairing is ``combination`` = C(D,2) pairs (45 for D=10).
"""

from __future__ import annotations

from collections import defaultdict
from itertools import combinations, product
from typing import List, Sequence, Tuple


def get_combination(keys: Sequence) -> List[Tuple[int, int]]:
    return list(combinations(range(len(keys)), 2))


def get_bipartite(keys: Sequence) -> List[Tuple[int, ...]]:
    views = defaultdict(list)
    for idx, key in enumerate(keys):
        views[key[0]].append(idx)
    return list(product(*views.values()))


def get_diagonal(keys: Sequence) -> List[List[int]]:
    names = defaultdict(list)
    for idx, key in enumerate(keys):
        names[key[1]].append(idx)
    return list(names.values())


def get_single_layer(keys: Sequence, layer: int = -1) -> List[List[int]]:
    """One group: every view's clustering of the ``layer``-th name in
    sorted order (retrieval ``cluster_pairing.py:24-34`` — the reference
    indexes the sorted name list positionally, not by name match)."""
    names = defaultdict(list)
    for idx, key in enumerate(keys):
        names[key[1]].append(idx)
    name = sorted(names)[layer]
    return [names[name]]


def get_penultimate(keys: Sequence) -> List[List[int]]:
    return get_single_layer(keys, layer=4)


_PAIRINGS = {
    "diagonal": get_diagonal,
    "bipartite": get_bipartite,
    "combination": get_combination,
    "penultimate": get_penultimate,
}


def get_cluster_pairing(keys: Sequence, cluster_pairing: str):
    cluster_pairing = cluster_pairing.lower()
    if cluster_pairing.startswith("layer_"):
        return get_single_layer(keys, int(cluster_pairing.rsplit("_", 1)[1]))
    if cluster_pairing not in _PAIRINGS:
        raise ValueError(f"invalid cluster pairing type: {cluster_pairing}")
    return _PAIRINGS[cluster_pairing](keys)
