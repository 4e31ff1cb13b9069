"""Retrieval experiment runner: the framework's ground-truth correctness
suite.

Counterpart of ``acav100m_tpu/retrieval/runner.py``, the port of
``correspondence_retrieval/code/run.py:42-133`` + grid runner
(``grid_search.py``): build paired views with known correspondence, derange
half the classes, cluster each (view, layer), greedily select, and score
precision/recall/F1 against the known matched set at every prefix.

Datasets: the reference used CIFAR10/MNIST(+rotations)/FSDD/Kinetics-Sounds
features extracted with a ResNet, none of which is downloaded here, so the
built-in dataset is synthetic paired gaussian views (optionally
multi-layer); other views plug in through the same dict format.

Clustering (``sgd``), the selectors and the contrastive probe run on
``device`` (default ``cuda``, raising without a card). The grid runs its
jobs on a spawn-context ``concurrent.futures.ProcessPoolExecutor``, so a
worker that dies raises ``BrokenProcessPool`` in the parent instead of
leaving it waiting.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pairing import get_cluster_pairing
from ..utils.io import dump_pickle
from .clustering import assignments_matrix, cluster_views
from .derangement import derange_views, precision_recall_f1, prefix_scores
from .measures import get_oracle_measure
from .optimizers import OPTIMIZERS, efficient_batch, efficient_greedy


def gaussian_pair_views(
    nclasses: int = 10,
    per_class: int = 30,
    dim: int = 16,
    num_layers: int = 2,
    noise: float = 0.3,
    seed: int = 0,
) -> Dict[str, Dict[str, Dict]]:
    """Two modalities x ``num_layers`` layers of class-gaussian features.

    Returns the derangement input format {view: {vid: {data, label}}};
    views are named ``{modality}-layer_{i}`` so bipartite/diagonal pairings
    work on (modality, layer) keys.
    """
    rng = np.random.RandomState(seed)
    views: Dict[str, Dict[str, Dict]] = {}
    class_means = {
        (m, l): rng.randn(nclasses, dim) * 2.0
        for m in ("audio", "visual")
        for l in range(num_layers)
    }
    for m in ("audio", "visual"):
        for l in range(num_layers):
            view_name = f"{m}-layer_{l}"
            view: Dict[str, Dict] = {}
            for c in range(nclasses):
                for i in range(per_class):
                    vid = f"c{c:02d}_{i:04d}"
                    feat = class_means[(m, l)][c] + noise * rng.randn(dim)
                    view[vid] = {"data": feat.astype(np.float32), "label": c}
            views[view_name] = view
    return views


def image_pair_views(
    images: np.ndarray,
    labels: np.ndarray,
    transform: str = "rotate",
    num_layers: int = 1,
    seed: int = 0,
) -> Dict[str, Dict[str, Dict]]:
    """Paired views from a real image dataset: (original, transformed)
    — the reference's CIFAR10/MNIST rotated/flipped pair experiments
    (``image_datasets.py:23-59``, ``image_pair_data.py``).

    Features are flattened pixels (each "layer" gets an independent random
    projection), standing in for the reference's pretrained-ResNet layers,
    whose weights are not in the repository.
    """
    rng = np.random.RandomState(seed)
    images = np.asarray(images, dtype=np.float32)
    if transform == "rotate":
        transformed = np.rot90(images, k=1, axes=(1, 2))
    elif transform == "flip":
        transformed = images[:, :, ::-1]
    else:
        raise ValueError(f"unknown transform {transform!r}")
    flat_a = images.reshape(len(images), -1)
    flat_b = transformed.reshape(len(images), -1)
    views: Dict[str, Dict[str, Dict]] = {}
    for mod, flat in (("orig", flat_a), (transform, flat_b)):
        for l in range(num_layers):
            proj = rng.randn(flat.shape[1], min(32, flat.shape[1])).astype(
                np.float32
            ) / np.sqrt(flat.shape[1])
            feats = flat @ proj
            views[f"{mod}-layer_{l}"] = {
                f"i{i:05d}": {"data": feats[i], "label": int(labels[i])}
                for i in range(len(images))
            }
    return views


def run_experiment(
    views: Optional[Dict] = None,
    deranged_classes_ratio: float = 0.5,
    ncentroids: int = 10,
    clustering_method: str = "sgd",
    optimizer: str = "efficient_greedy",
    measure: str = "mi",
    pairing: str = "combination",
    selection_size: Optional[int] = None,
    seed: int = 0,
    out_path=None,
    batch_size: int = 20,
    batch_selection_size: int = 4,
    device=None,
) -> Dict:
    """One experiment -> result dict with precision/recall/f1 (+ prefixes),
    the JAX package's dict; clustering and selection on ``device``."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    if views is None:
        views = gaussian_pair_views(seed=seed)
    der = derange_views(views, deranged_classes_ratio, rng=rng)
    feats = {
        view: np.stack([d["data"] for d in rows])
        for view, rows in der["features"].items()
    }
    clusterings = cluster_views(
        feats, ncentroids, method=clustering_method, seed=seed, device=device
    )
    assignments = assignments_matrix(clusterings)
    keys = [tuple(k.split("-", 1)) for k in sorted(clusterings)]
    pairs = get_cluster_pairing(keys, pairing)

    subset_size = selection_size or der["subset_size"]
    start = [int(rng.randint(der["dataset_size"]))]
    if optimizer == "efficient_greedy":
        order, gains = efficient_greedy(
            assignments, pairs, ncentroids, subset_size, start, kind=measure,
            device=device,
        )
    elif optimizer == "efficient_batch":
        order, gains = efficient_batch(
            assignments, pairs, ncentroids, subset_size, start,
            batch_size=batch_size, selection_size=batch_selection_size,
            seed=seed, device=device,
        )
    elif optimizer == "pca_rank":
        from .clustering import whiten
        from .pca_optim import pca_rank_selection, pca_project

        projections = [
            pca_project(whiten(feats[v])) for v in sorted(feats)
        ]
        order, gains = pca_rank_selection(
            projections, pairs, subset_size, measure=measure
        )
    elif optimizer in ("greedy", "celf"):
        oracle = get_oracle_measure(measure, assignments, pairs)
        order, gains = OPTIMIZERS[optimizer](
            oracle, der["dataset_size"], subset_size, start
        )
    elif optimizer == "contrastive":
        # the MetricLearning measure (reference measures/metric.py:47-155 +
        # contrastive.py): train the two-projection InfoNCE probe on the
        # deranged pair features, rank every sample by aligned-projection
        # inner product — matched pairs align, deranged ones don't
        from ..pipeline.contrastive_selection import (
            alignment_scores,
            train_probe,
        )

        groups: Dict[str, list] = {}
        for k in sorted(feats):
            groups.setdefault(k.split("-", 1)[0], []).append(k)
        if len(groups) != 2:
            raise ValueError(
                f"contrastive needs exactly two view groups, got {sorted(groups)}"
            )
        side_a, side_b = sorted(groups)
        va = feats[groups[side_a][-1]]  # penultimate = last layer per side
        vb = feats[groups[side_b][-1]]
        # small experiment datasets need the step count, not the epoch
        # count, held roughly constant (the reference trains at 100M-clip
        # scale where 3 epochs is plenty, run_contrastive.py)
        steps_per_epoch = max(len(va) // min(128, len(va)), 1)
        epochs = max(3, -(-300 // steps_per_epoch))
        probe = train_probe(va, vb, num_epochs=epochs, seed=seed, device=device)
        scores = alignment_scores(probe, va, vb)
        order = np.argsort(-scores).tolist()
        gains = np.sort(scores)[::-1].tolist()
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    order = order[:subset_size]
    p, r, f1 = precision_recall_f1(order, der["true_ids"])
    result = {
        "config": {
            "deranged_classes_ratio": deranged_classes_ratio,
            "ncentroids": ncentroids,
            "clustering_method": clustering_method,
            "optimizer": optimizer,
            "measure": measure,
            "pairing": pairing,
            "seed": seed,
        },
        "precision": p,
        "recall": r,
        "f1": f1,
        "subset_size": subset_size,
        "dataset_size": der["dataset_size"],
        "prefix_scores": prefix_scores(order, der["true_ids"],
                                       every=max(subset_size // 10, 1)),
        "selection": list(map(int, order)),
        "true_ids": der["true_ids"],
    }
    if out_path is not None:
        dump_pickle(result, out_path)
    return result


def _pin_worker(counter, num_cards: int) -> None:
    """Pool initializer: on ``cuda`` the i-th worker started takes card
    ``i % num_cards`` as its current device, so ``cuda`` jobs run there."""
    if num_cards:
        with counter.get_lock():
            index = counter.value
            counter.value += 1
        torch.cuda.set_device(index % num_cards)


def _grid_worker(payload):
    kwargs, out_path, views = payload
    kwargs = dict(kwargs)
    data_name = kwargs.pop("data_name", None)
    if views is None and data_name is not None:
        from .features import views_for_data_name

        views = views_for_data_name(data_name, seed=kwargs.get("seed", 0),
                                    device=kwargs.get("device"))
    result = run_experiment(views=views, out_path=out_path, **kwargs)
    if data_name is not None:
        result["data_name"] = data_name
    return result


# reference grid-json key spellings -> run_experiment kwargs
# (correspondence_retrieval/code/grid_search.py + args.py:4-61)
REFERENCE_KEY_ALIASES = {
    "cluster_pairing": "pairing",
    "clustering_func_type": "clustering_method",
    "measure_type": "measure",
    "optimization": "optimizer",
    "nclusters": "ncentroids",
}
# reference clustering_func_type values -> our method names. The JAX
# package maps scipy_kmeans to "sklearn++", which no frontend has; the port
# maps it to the scipy frontend (kmeans2 with ++ init)
_CLUSTERING_ALIASES = {"sgd_kmeans": "sgd", "faiss_kmeans": "sklearn",
                       "scipy_kmeans": "scipy", "pca": "pca"}
# reference measure names bundle the optimizer choice
# (correspondence_retrieval measures/__init__.py:23-66)
_MEASURE_TRANSLATIONS = {
    "efficient_batch_mi": {"optimizer": "efficient_batch", "measure": "mi"},
    "efficient_mi": {"optimizer": "efficient_greedy", "measure": "mi"},
    "efficient_ami": {"optimizer": "efficient_greedy", "measure": "ami"},
    "efficient_nmi": {"optimizer": "efficient_greedy", "measure": "nmi"},
    "constant": {"optimizer": "efficient_greedy", "measure": "constant"},
    "fm": {"optimizer": "efficient_greedy", "measure": "fm"},
    "rand": {"optimizer": "efficient_greedy", "measure": "rand"},
    "arand": {"optimizer": "efficient_greedy", "measure": "arand"},
    "contrastive": {"optimizer": "contrastive", "measure": "mi"},
}


def load_option_grid(path) -> List[Dict]:
    """Parse a grid json into a list of per-job kwargs.

    Accepts both formats:
    * the reference's ``search_targets/**/*.json``: a LIST of option
      groups, each a list of dicts — the grid is the cartesian product of
      one dict per group, merged (``grid_search.py:104-140``). Keys are
      translated through ``REFERENCE_KEY_ALIASES``; keys with no
      counterpart here are dropped with a warning.
    * a DICT of ``{kwarg: [values...]}`` (this package's native format).
    """
    import inspect
    import json
    import warnings

    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        keys = sorted(data)
        return [dict(zip(keys, combo))
                for combo in itertools.product(*[data[k] for k in keys])]
    known = set(inspect.signature(run_experiment).parameters)
    jobs = []
    dropped = set()
    for combo in itertools.product(*data):
        merged: Dict = {}
        for d in combo:
            merged.update(d)
        kwargs: Dict = {}
        nexprs = 1
        for k, v in merged.items():
            k = REFERENCE_KEY_ALIASES.get(k, k)
            if k == "selection_size":
                # in the reference grids selection_size is the per-batch
                # top-k fed to EfficientBatchMI, not the subset size
                k = "batch_selection_size"
            if k == "clustering_method":
                v = _CLUSTERING_ALIASES.get(v, v)
            if k == "measure" and v in _MEASURE_TRANSLATIONS:
                kwargs.update(_MEASURE_TRANSLATIONS[v])
                continue
            if k == "nexprs":  # reference: repeat each config N times
                nexprs = int(v)
                continue
            if k == "data_name":  # resolved to views by the grid worker
                kwargs[k] = v
                continue
            if k in known:
                kwargs[k] = v
            else:
                dropped.add(k)
        for rep in range(max(nexprs, 1)):
            jobs.append({**kwargs, "seed": kwargs.get("seed", 0) + rep})
    if dropped:
        warnings.warn(
            f"grid keys with no counterpart here were dropped: {sorted(dropped)}"
        )
    return jobs


def grid_search(option_grid: Optional[Dict[str, Sequence]] = None,
                out_dir=None,
                views: Optional[Dict] = None,
                num_workers: Optional[int] = None,
                job_kwargs: Optional[List[Dict]] = None) -> List[Dict]:
    """Cartesian-product grid over ``run_experiment`` kwargs, on a process
    pool (reference ``grid_search.py:25-175``: CPU pool of 50 + per-GPU
    spawn).

    Provide either ``option_grid`` ({kwarg: [values...]}) or
    ``job_kwargs`` (a pre-built list of kwarg dicts, e.g. from
    ``load_option_grid``). Each job runs on its ``device`` kwarg (default
    ``cuda``). ``num_workers=None`` sizes the pool to one worker per
    visible card when a job runs on ``cuda`` (the reference's per-GPU
    spawn), else to min(jobs, cpu_count); ≤1 runs inline. Workers are
    spawned (fork after CUDA init is invalid), and the i-th takes card
    ``i % cards``, so an explicit ``num_workers`` may put several on one
    card. A worker that dies raises ``BrokenProcessPool``.
    """
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    if job_kwargs is None:
        keys = sorted(option_grid or {})
        job_kwargs = [
            dict(zip(keys, combo))
            for combo in itertools.product(*[option_grid[k] for k in keys])
        ]
    jobs = []
    for i, kwargs in enumerate(job_kwargs):
        out_path = None
        if out_dir is not None:
            tag = "_".join(f"{k}-{v}" for k, v in sorted(kwargs.items()))
            out_path = Path(out_dir) / f"result_{i:04d}_{tag}.pkl"
        jobs.append((kwargs, out_path, views))
    on_cuda = any(resolve_device(kw.get("device")).type == "cuda" for kw in job_kwargs)
    num_cards = torch.cuda.device_count() if on_cuda else 0
    if num_workers is None:
        num_workers = min(len(jobs), num_cards if on_cuda else max(1, os.cpu_count() or 1))
    if num_workers <= 1:
        return [_grid_worker(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    counter = ctx.Value("i", 0)
    with ProcessPoolExecutor(num_workers, mp_context=ctx, initializer=_pin_worker,
                             initargs=(counter, num_cards)) as pool:
        return list(pool.map(_grid_worker, jobs))
