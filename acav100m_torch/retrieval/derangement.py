"""Derangement ground-truth construction.

A copy of ``acav100m_tpu/retrieval/derangement.py`` (the port imports nothing of
the JAX package).

Port of ``correspondence_retrieval/code/derangement/{derangement,common}.py``:
build a dataset with KNOWN audio-visual correspondence by deranging a
fraction of classes between views — datapoints of still-matched classes keep
aligned indices across views (``true_ids``), deranged classes get
independently shuffled rows. Selection algorithms are then scored by
precision/recall/F1 of recovering ``true_ids``.

Differences: explicit ``np.random.RandomState`` instead of the global
``random`` module (reproducible under parallel grids), plain dicts in/out.
Views are ``{view_name: {vid: {'data': array, 'label': any}}}``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def categorize_data(view: Dict[str, Dict]) -> Dict:
    """{vid: {data,label}} -> {label: [datum,...]} (vid-sorted, stable)."""
    classes = defaultdict(dict)
    for vid, datum in view.items():
        classes[datum["label"]][vid] = datum
    return {
        label: [dt[k] for k in sorted(dt)] for label, dt in classes.items()
    }


def derange_views(
    views: Dict[str, Dict[str, Dict]],
    deranged_classes_ratio: float = 0.5,
    rng: Optional[np.random.RandomState] = None,
    class_datapoints_threshold: Optional[int] = None,
    shuffle_true_ids: bool = True,
) -> Dict:
    """Build the deranged experiment.

    Returns dict with ``features`` {view: [datum,...]} (index-aligned),
    ``true_ids`` (indices whose rows correspond across views),
    ``dataset_size``, ``subset_size``, ``matched_classes`` {view: [labels]}.
    """
    if rng is None:
        rng = np.random.RandomState(0)
    cat = {view: categorize_data(v) for view, v in views.items()}

    # clip to common class count, shuffle class pairing once for all views
    keys = {view: sorted(classes.keys()) for view, classes in cat.items()}
    nclasses = min(len(k) for k in keys.values())
    keys = {view: k[:nclasses] for view, k in keys.items()}
    order = rng.permutation(nclasses)
    keys = {view: [k[i] for i in order] for view, k in keys.items()}

    num_deranged = math.floor(deranged_classes_ratio * nclasses)
    num_matched = nclasses - num_deranged

    # per class: clip datapoints to common count, aligned order
    all_features: Dict[str, List] = defaultdict(list)
    subset_size = 0
    dataset_size = 0
    for i in range(nclasses):
        view_classes = {view: cat[view][keys[view][i]] for view in cat}
        n = min(len(v) for v in view_classes.values())
        if class_datapoints_threshold is not None:
            n = min(n, class_datapoints_threshold)
        # aligned shuffle within the class (reference shuffle_each_view with
        # shuffle_datapoints=False keeps views aligned; True shuffles per
        # view-model group — here views stay aligned inside a class, the
        # derangement itself destroys alignment for deranged classes)
        idx = rng.permutation(n)
        for view, data in view_classes.items():
            all_features[view].extend([data[j] for j in idx])
        if i < num_matched:
            subset_size += n
        dataset_size += n

    # choose where matched rows live, shuffle them consistently
    true_shuffle = rng.permutation(subset_size)
    if shuffle_true_ids:
        true_ids = sorted(
            rng.choice(dataset_size, size=subset_size, replace=False).tolist()
        )
    else:
        true_ids = list(range(subset_size))
    wrong_shuffles = {
        view: rng.permutation(dataset_size - subset_size) for view in all_features
    }

    final: Dict[str, List] = {}
    for view, features in all_features.items():
        true_matches = [features[:subset_size][i] for i in true_shuffle]
        wrong = [features[subset_size:][i] for i in wrong_shuffles[view]]
        rows: List = []
        ti = list(true_ids)
        for i in range(dataset_size):
            if ti and i == ti[0]:
                rows.append(true_matches.pop(0))
                ti.pop(0)
            else:
                rows.append(wrong.pop(0))
        assert not true_matches and not wrong
        final[view] = rows

    matched_classes = {view: k[:num_matched] for view, k in keys.items()}
    return {
        "features": final,
        "true_ids": list(true_ids),
        "dataset_size": dataset_size,
        "subset_size": subset_size,
        "nclasses": nclasses,
        "matched_classes": matched_classes,
    }


def derange_views_sample_level(
    views: Dict[str, Dict[str, Dict]],
    deranged_samples_ratio: float = 0.5,
    rng: Optional[np.random.RandomState] = None,
    shuffle_true_ids: bool = True,
) -> Dict:
    """Sample-level derangement (reference derangement/sample_level.py):
    derange a FRACTION OF SAMPLES regardless of class — matched rows stay
    aligned across views, deranged rows are shuffled independently per view.

    Same output dict as ``derange_views`` (``matched_classes`` is None: at
    sample level every class contains both matched and deranged rows).
    """
    if rng is None:
        rng = np.random.RandomState(0)
    # align views on common vids (match_datapoints, common.py:37-53)
    common = None
    for view in views.values():
        keys = set(view.keys())
        common = keys if common is None else (common & keys)
    vids = sorted(common)
    dataset_size = len(vids)
    subset_size = dataset_size - math.floor(deranged_samples_ratio * dataset_size)

    order = rng.permutation(dataset_size)  # which rows are candidates
    matched_vids = [vids[i] for i in order[:subset_size]]
    deranged_vids = [vids[i] for i in order[subset_size:]]

    if shuffle_true_ids:
        true_ids = sorted(
            rng.choice(dataset_size, size=subset_size, replace=False).tolist()
        )
    else:
        true_ids = list(range(subset_size))
    true_shuffle = rng.permutation(subset_size)
    wrong_shuffles = {
        view: rng.permutation(dataset_size - subset_size) for view in views
    }

    final: Dict[str, List] = {}
    for view, data in views.items():
        matched_rows = [data[matched_vids[i]] for i in true_shuffle]
        wrong_rows = [data[deranged_vids[i]] for i in wrong_shuffles[view]]
        rows: List = []
        ti = list(true_ids)
        for i in range(dataset_size):
            if ti and i == ti[0]:
                rows.append(matched_rows.pop(0))
                ti.pop(0)
            else:
                rows.append(wrong_rows.pop(0))
        final[view] = rows

    return {
        "features": final,
        "true_ids": list(true_ids),
        "dataset_size": dataset_size,
        "subset_size": subset_size,
        "nclasses": len({d["label"] for d in next(iter(views.values())).values()}),
        "matched_classes": None,
    }


def split_views(
    views: Dict[str, Dict[str, Dict]],
    train_ratio: float = 0.8,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[Dict, Dict]:
    """Per-class train/test split of paired views (reference
    derangement/split.py) — used by the metric-learning probe."""
    if rng is None:
        rng = np.random.RandomState(0)
    first = next(iter(views.values()))
    by_class = defaultdict(list)
    for vid in sorted(first):
        by_class[first[vid]["label"]].append(vid)
    train_vids, test_vids = set(), set()
    for label, vids in by_class.items():
        vids = list(vids)
        rng.shuffle(vids)
        cut = round(len(vids) * train_ratio)
        train_vids.update(vids[:cut])
        test_vids.update(vids[cut:])
    train = {v: {k: d for k, d in data.items() if k in train_vids}
             for v, data in views.items()}
    test = {v: {k: d for k, d in data.items() if k in test_vids}
            for v, data in views.items()}
    return train, test


def precision_recall_f1(
    selected: Sequence[int], true_ids: Sequence[int]
) -> Tuple[float, float, float]:
    """Score a selection against the known matched set
    (reference common.py:84-91)."""
    s, t = set(selected), set(true_ids)
    if not s or not t:
        return 0.0, 0.0, 0.0
    inter = len(s & t)
    precision = inter / len(s)
    recall = inter / len(t)
    f1 = 0.0
    if precision + recall > 0:
        f1 = 2 * precision * recall / (precision + recall)
    return precision, recall, f1


def prefix_scores(order: Sequence[int], true_ids: Sequence[int],
                  every: int = 1) -> List[Dict]:
    """precision/recall/f1 at every prefix of the selection order
    (reference run.py:105-112)."""
    out = []
    for i in range(every, len(order) + 1, every):
        p, r, f = precision_recall_f1(order[:i], true_ids)
        out.append({"k": i, "precision": p, "recall": r, "f1": f})
    return out
