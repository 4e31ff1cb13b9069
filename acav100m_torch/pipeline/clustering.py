"""Stage 5 — per-(model, layer) mini-batch k-means over feature shards.

Port of ``acav100m_tpu/pipeline/clustering.py`` (reference
``clustering/code/run_clustering.py:25-272``) with the same config keys,
defaults and artifacts:

* phase A trains all M clusterings fused in one stacked ``KMeansState``;
  after warmup each step goes through kernel K1 when
  ``computation.use_pallas`` (default True here);
* per-epoch centroid caches ``cache_epoch_{e}_{specname}`` with the JAX
  package's pickle schema (numpy arrays), so caches cross-load both ways;
* phase B writes assignment pkls with rows ``{filename, shard_name,
  shard_size, video_assignments, audio_assignments}`` plus a ``log_*.json``
  manifest.

Random draws (initial centers, warmup assignment) come from
``torch.Generator``s seeded from ``computation.random_seed``; they differ
from the JAX package's ``jax.random`` draws, so two runs agree only from a
shared cache past warmup.

Data parallel (``group=``, a ``runtime.Group``, one process per card; the
JAX package's ``mesh=``): the rank and world size take the place of
``computation.index``/``total``. In phase A every rank reads all shards
from its own offset (``node_selection(is_train=True)``, wrapping around),
so every rank takes the same number of full batches and the all-reduce in
each step cannot deadlock; every rank starts from rank 0's state and then
holds the same state after each step; rank 0 writes the ``cache_epoch_*``
files and the others wait at a barrier.
Phase B assigns each rank's own shards.
"""

from __future__ import annotations

import itertools
import math
import random
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..config import Config, build_config
from ..ops import kmeans
from ..runtime import Group, barrier, broadcast, group_device, placement
from ..utils.braceexpand import braceexpand
from ..utils.io import dump_pickle, load_pickle
from ..utils.manifests import write_run_manifest
from ..utils.shards import node_selection, plan_shards

DEFAULTS = {
    "models": ["layer_vggish", "layer_slowfast"],
    "model_types": {
        "audio": ["vggish", "layer_vggish"],
        "visual": ["slowfast", "layer_slowfast", "layer_slowfast_nln"],
    },
    "data": {
        "path": None,  # feature pkl shard spec, e.g. .../shard-{000000..000019}.pkl
        "batch_size": 1024,
        "output": {"path": "clusters"},
    },
    "computation": {
        "random_seed": 0,
        "index": 0,
        "total": 1,
        "shuffle_bufsize": 1000,
        # post-warmup steps through kernel K1 (plain version on the CPU)
        "use_pallas": True,
        "device": "cuda",
    },
    "clustering": {
        "ncentroids": 32,
        "epochs": 2,
        "cached_epoch": None,
        "resume_training": False,
        "load_cache_from_shard_subset": True,
        "save_epoch_prefix": False,
    },
    "log_period": 10,
}


def get_config(overrides: Optional[Dict] = None) -> Config:
    return build_config(DEFAULTS, overrides, strict=True)


# -- clustering-type discovery -------------------------------------------------

def clustering_types_from_row(row: Dict) -> List[Tuple[str, str]]:
    """(model_key, layer) keys of one feature row, sorted — the clustering
    type order used everywhere downstream (``dataloader.py:44-58``)."""
    types = []
    for side in ("audio_features", "video_features"):
        for feat in row.get(side, []):
            arr = feat["array"]
            if isinstance(arr, dict):
                for layer in arr:
                    types.append((feat["model_key"], layer))
            else:
                types.append((feat["model_key"], "model"))
    return sorted(types)


def row_features(row: Dict, types: Sequence[Tuple[str, str]]) -> List[np.ndarray]:
    by_key = {}
    for side in ("audio_features", "video_features"):
        for feat in row.get(side, []):
            arr = feat["array"]
            if isinstance(arr, dict):
                for layer, v in arr.items():
                    by_key[(feat["model_key"], layer)] = np.asarray(v)
            else:
                by_key[(feat["model_key"], "model")] = np.asarray(arr)
    return [by_key[t] for t in types]


def iter_feature_rows(shard_paths: Sequence) -> Iterator[Dict]:
    """Stream rows from feature pkls, skip-and-continue on bad shards."""
    for path in shard_paths:
        try:
            with tracing.span("span.cluster.unpickle"):
                rows = load_pickle(path)
        except Exception as e:
            print(f"skipping unreadable shard {path}: {e}")
            continue
        for row in rows:
            yield row


def buffered_shuffle(source: Iterable, bufsize: int, rng: random.Random,
                     initial: int = 100):
    """Buffered stream shuffle — the exact webdataset algorithm the
    reference vendors (``clustering/code/data/shuffle.py:10-36``), double-
    advance fill and reduced-randomness startup included; identical to the
    JAX package's ``buffered_shuffle`` under a shared ``random.Random``. A
    single-sample stream yields its sample (upstream crashes there)."""
    data = iter(source)
    initial = min(initial, bufsize)
    buf: List = []
    startup = True
    for sample in data:
        if len(buf) < bufsize:
            try:
                buf.append(next(data))
            except StopIteration:
                pass
        if not buf:
            yield sample
            continue
        k = rng.randint(0, len(buf) - 1)
        sample, buf[k] = buf[k], sample
        if startup and len(buf) < initial:
            buf.append(sample)
            continue
        startup = False
        yield sample
    for sample in buf:
        yield sample


def stack_batch(
    rows: List[Dict], types: Sequence[Tuple[str, str]], dmax: int
) -> np.ndarray:
    """rows -> (M, B, Dmax) zero-padded feature tensor."""
    out = np.zeros((len(types), len(rows), dmax), dtype=np.float32)
    for bi, row in enumerate(rows):
        for mi, f in enumerate(row_features(row, types)):
            out[mi, bi, : f.shape[-1]] = f
    return out


# -- centroid caches -----------------------------------------------------------

def _spec_name(cfg) -> str:
    return Path(str(cfg.data.path)).name


def cache_path(cfg, epoch: int) -> Path:
    return Path(cfg.data.output.path) / f"cache_epoch_{epoch}_{_spec_name(cfg)}"


def save_centroids(cfg, epoch: int, state: kmeans.KMeansState,
                   types: Sequence[Tuple[str, str]], dims: Sequence[int]):
    out = {
        "types": [list(t) for t in types],
        "dims": list(dims),
        "epoch": epoch,
        "kmeans": kmeans.get_attrs(state, lr=kmeans.lr_schedule(epoch)),
    }
    dump_pickle(out, cache_path(cfg, epoch))


def find_centroid_cache(cfg, epoch: int) -> Optional[Path]:
    """Exact cache, else a cache covering a SUBSET of our shards
    (``run_clustering.py:76-84``)."""
    path = cache_path(cfg, epoch)
    if path.is_file():
        return path
    if not cfg.clustering.load_cache_from_shard_subset:
        return None
    out_dir = Path(cfg.data.output.path)
    our_shards = set(braceexpand(_spec_name(cfg)))
    candidates = {}
    for p in out_dir.glob(f"cache_epoch_{epoch}_*"):
        tail = p.name[p.name.find("shard-"):] if "shard-" in p.name else p.name
        covered = set(braceexpand(tail))
        if not (covered - our_shards):
            candidates[p] = len(covered)
    if not candidates:
        return None
    return max(candidates.items(), key=lambda kv: kv[1])[0]


def load_centroids(path, device=None):
    dt = load_pickle(path)
    state = kmeans.load_attrs(dt["kmeans"], device=device)
    types = [tuple(t) for t in dt["types"]]
    return state, types, list(dt["dims"])


# -- phase A: training -----------------------------------------------------------

def discover_types(shard_paths) -> Tuple[List[Tuple[str, str]], List[int]]:
    for row in iter_feature_rows(shard_paths):
        types = clustering_types_from_row(row)
        dims = [f.shape[-1] for f in row_features(row, types)]
        return types, dims
    raise RuntimeError("no feature rows found")


def train_clusters(cfg, group: Optional[Group] = None):
    """Phase A. Returns (state, types, dims)."""
    with tracing.span("span.cluster.setup"):
        device = group_device(cfg.computation.device, group)
        out_dir = Path(cfg.data.output.path)
        out_dir.mkdir(parents=True, exist_ok=True)
        index, total = placement(cfg.computation.index, cfg.computation.total, group)
        seed = cfg.computation.random_seed or 0

        _, all_shards = plan_shards(cfg.data.path, index=index, total=total, suffix=".pkl")
        all_shards = [p for p in all_shards if Path(p).is_file()]
        train_shards = node_selection(all_shards, index=index, total=total, is_train=True)
        types, dims = discover_types(train_shards)

        # resume (reference semantics, run_clustering.py:142-144: re-train epoch
        # `cached_epoch` starting from the state saved after it)
        cached_epoch = cfg.clustering.cached_epoch
        pre_epochs = 0
        state = None
        if isinstance(cached_epoch, int):
            found = find_centroid_cache(cfg, cached_epoch)
            if found is not None:
                state, types, dims = load_centroids(found, device)
                if not cfg.clustering.resume_training:
                    return state, types, dims
                pre_epochs = cached_epoch
        if state is None:
            state = kmeans.init_state(
                dims, cfg.clustering.ncentroids or 32,
                generator=torch.Generator().manual_seed(seed), device=device,
            )
        # every rank starts from rank 0's centers (the reference all-reduces its
        # random init, sgd_clustering.py:88-92)
        broadcast(state.centers, group)

        epochs = math.ceil((cfg.clustering.epochs or 2) / total)
        batch_size = cfg.data.batch_size or 1024
        dmax = int(state.centers.shape[-1])
        rng = random.Random(seed)
        warmup_gen = torch.Generator().manual_seed(seed + 1 + index)
        use_pallas = bool(cfg.computation.use_pallas)

    step = 0
    for epoch in range(pre_epochs, pre_epochs + epochs):
        lr = kmeans.lr_schedule(epoch)
        source = iter_feature_rows(train_shards)
        if cfg.computation.shuffle_bufsize:
            source = buffered_shuffle(source, cfg.computation.shuffle_bufsize, rng)
        while True:
            with tracing.span("span.cluster.step", unit=step):
                with tracing.span("span.cluster.shuffle"):
                    buf = list(itertools.islice(source, batch_size))
                # drop_last=True in the reference train loader
                if len(buf) < batch_size:
                    break
                with tracing.span("span.cluster.stack_batch"):
                    stacked = stack_batch(buf, types, dmax)
                with tracing.span("span.cluster.copy"):
                    batch = torch.from_numpy(stacked).to(device)
                with tracing.span("span.cluster.train_step"):
                    state, _ = kmeans.train_step(state, batch, lr, generator=warmup_gen,
                                                 use_pallas=use_pallas, group=group)
                tracing.count("cluster.steps")
                tracing.count("cluster.rows", len(buf))
                tracing.count("cluster.h2d_bytes", stacked.nbytes)
            step += 1
        with tracing.span("span.cluster.save"):
            if group is None or group.rank == 0:
                save_centroids(cfg, epoch, state, types, dims)
            barrier(group)
    return state, types, dims


# -- phase B: assignment ---------------------------------------------------------

def assign_clusters(cfg, state: kmeans.KMeansState,
                    types: Sequence[Tuple[str, str]], group: Optional[Group] = None):
    """Phase B over this process's shards. Returns saved assignment pkl
    paths."""
    with tracing.span("span.cluster.setup"):
        device = state.centers.device
        out_dir = Path(cfg.data.output.path)
        index, total = placement(cfg.computation.index, cfg.computation.total, group)
        mine, _ = plan_shards(cfg.data.path, index=index, total=total, suffix=".pkl")
        mine = [p for p in mine if Path(p).is_file()]

        prefix = ""
        if cfg.clustering.save_epoch_prefix and isinstance(cfg.clustering.cached_epoch, int):
            prefix = f"epoch_{cfg.clustering.cached_epoch}_"

        audio_keys = set(cfg.model_types.audio or [])
        dmax = int(state.centers.shape[-1])
        batch_size = cfg.data.batch_size or 1024

        by_model: "OrderedDict[str, List[Tuple[int, str]]]" = OrderedDict()
        for mi, (model_key, layer) in enumerate(types):
            by_model.setdefault(model_key, []).append((mi, layer))

    saved_paths: List[Path] = []
    for shard_path in mine:
        shard_name = Path(shard_path).stem
        out_path = out_dir / f"{prefix}{shard_name}.pkl"
        if out_path.is_file():
            continue
        try:
            with tracing.span("span.cluster.unpickle"):
                rows = load_pickle(shard_path)
        except Exception as e:
            print(f"skipping unreadable shard {shard_path}: {e}")
            continue
        out_rows: List[Dict] = []
        for start in range(0, len(rows), batch_size):
            chunk = rows[start : start + batch_size]
            with tracing.span("span.cluster.stack_batch"):
                stacked = stack_batch(chunk, types, dmax)
            with tracing.span("span.cluster.copy"):
                batch = torch.from_numpy(stacked).to(device)
            tracing.count("cluster.rows", len(chunk))
            tracing.count("cluster.h2d_bytes", stacked.nbytes)
            with tracing.span("span.cluster.assign"):
                best = kmeans.assign_step(state, batch)
            with tracing.span("span.cluster.assign_read"):
                best = best.cpu().numpy()  # (M, B)
            with tracing.span("span.cluster.rows"):
                for bi, row in enumerate(chunk):
                    out_row = {
                        "filename": row["filename"],
                        "shard_name": row["shard_name"],
                        "shard_size": row["shard_size"],
                        "video_assignments": [],
                        "audio_assignments": [],
                    }
                    for model_key, layers in by_model.items():
                        arr = {layer: int(best[mi, bi]) for mi, layer in layers}
                        side = ("audio_assignments" if model_key in audio_keys
                                else "video_assignments")
                        out_row[side].append({"model_key": model_key, "array": arr})
                    out_rows.append(out_row)
        with tracing.span("span.cluster.save"):
            dump_pickle(out_rows, out_path)
        saved_paths.append(out_path)
    with tracing.span("span.cluster.save"):
        write_run_manifest(out_dir, saved_paths)
    return saved_paths


def run_clustering(cfg, group: Optional[Group] = None):
    """Full stage: train then assign (``run_clustering.py:25-30``)."""
    state, types, dims = train_clusters(cfg, group)
    return assign_clusters(cfg, state, types, group)
