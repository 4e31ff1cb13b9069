"""Stage 6 — greedy pairwise-MI subset selection.

Port of ``acav100m_tpu/pipeline/subset_selection.py`` (reference
``subset_selection/code/{run.py,run_greedy.py,dataloader.py,save.py}``)
with the same config keys, defaults and ``output.csv``:

* assignment pkl shards are grouped into partitions by ``log_*.json`` run
  manifests (newer logs win; shards without logs -> partition -1);
* per partition: the assignment matrix (V x D, clustering types sorted),
  the cluster pairing (default ``combination`` = C(D,2)), batched greedy MI
  maximization (B=20, k=4, keep_unselected) down to ``subset.ratio``=0.2;
* csv rows ``shard_name,filename,id,segment`` joined from the shard jsons.

``computation.dtype`` ``float64`` runs the contingency cache and the scores
in float64, the reference's own precision; ``bfloat16`` runs them in bf16,
rounded at every op, as the JAX package does. Only the production measure
``batch_mi`` is ported; chunk mode (``chunk_size``) is not.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config, build_config
from ..device import resolve_device
from ..ops.mi import BatchGreedySelector
from ..ops.pairing import get_cluster_pairing
from ..utils.braceexpand import braceexpand
from ..utils.io import load_json, load_pickle, save_output_csv
from ..utils.manifests import read_run_manifests

DEFAULTS = {
    "data": {
        "path": None,  # assignment pkl spec
        "output": {"path": "output.csv"},
        "meta": {"path": None},  # dir or spec of shard jsons
    },
    "computation": {"random_seed": 0, "dtype": "float32", "device": "cuda"},
    "subset": {"ratio": 0.2, "size": None},
    "clustering": {"pairing": "combination"},
    "batch": {"batch_size": 20, "selection_size": 4, "keep_unselected": True},
    "measure_name": "batch_mi",
    "shuffle_candidates": True,
    "chunk_size": None,
    "log_every": 1000,
    "verbose": False,
}


def get_config(overrides: Optional[Dict] = None) -> Config:
    return build_config(DEFAULTS, overrides, strict=True)


# -- loading --------------------------------------------------------------------

def expand_shard_paths(spec) -> List[Path]:
    """Brace spec or explicit list -> sorted existing files
    (``dataloader.py:152-160`` accepts both)."""
    if isinstance(spec, (list, tuple)):
        paths = sorted(str(p) for p in spec)
    else:
        paths = sorted(braceexpand(str(spec)))
    return [Path(p) for p in paths if Path(p).is_file()]


def load_partitions_data(shard_paths: Sequence[Path]) -> Dict[int, List[Dict]]:
    """Assignment rows grouped by manifest partition
    (``dataloader.py:152-204``)."""
    if not shard_paths:
        return {}
    partitions = read_run_manifests(Path(shard_paths[0]).parent)
    grouped: Dict[int, List[Dict]] = defaultdict(list)
    for path in shard_paths:
        pid = partitions.get(Path(path).stem, -1)
        grouped[pid].extend(load_pickle(path))
    return dict(grouped)


def format_rows(
    rows: Sequence[Dict],
) -> Tuple[np.ndarray, List[str], List[str], List[Tuple[str, str]]]:
    """Assignment rows -> (V x D matrix, shard_names, filenames, types);
    types sorted (``dataloader.py:17-58``)."""
    parsed = []
    for row in rows:
        res = {}
        for side in ("audio_assignments", "video_assignments"):
            for feat in row.get(side, []):
                arr = feat["array"]
                if isinstance(arr, dict):
                    for layer, v in arr.items():
                        res[(feat["model_key"], layer)] = v
                elif isinstance(arr, (list, tuple)):
                    for i, v in enumerate(arr):
                        res[(feat["model_key"], f"layer_{i}")] = v
                else:
                    res[(feat["model_key"], "model")] = arr
        parsed.append((row["filename"], row["shard_name"], res))
    types = sorted(parsed[0][2].keys())
    assignments = np.asarray(
        [[res[t] for t in types] for _, _, res in parsed], dtype=np.int64
    )
    filenames = [p[0] for p in parsed]
    shard_names = [p[1] for p in parsed]
    return assignments, shard_names, filenames, types


def load_metas(meta_path, shard_paths: Sequence[Path]) -> Dict[str, Dict]:
    """{shard_name: {stem: {id, segment}}} from the stage-3 shard jsons."""
    metas: Dict[str, Dict] = {}
    if meta_path is None:
        return metas
    meta_path = Path(meta_path)
    for shard_path in shard_paths:
        stem = Path(shard_path).stem
        # strip any epoch_{n}_ prefix for meta lookup
        name = stem.split("_")[-1] if stem.startswith("epoch_") else stem
        json_path = meta_path / f"{name}.json" if meta_path.is_dir() else Path(
            str(meta_path).replace("{shard}", name)
        )
        if json_path.is_file():
            rows = load_json(json_path)
            metas[name] = {
                Path(r["filename"]).stem: {"id": r.get("id"), "segment": r.get("segment")}
                for r in rows
            }
    return metas


# -- selection --------------------------------------------------------------------

def run_greedy_partition(cfg, rows: Sequence[Dict], device=None) -> List[Dict]:
    """Select from one partition; returns [{filename, shard_name}] sorted by
    index (``run_greedy.py:9-74``)."""
    measure_name = cfg.measure_name or "batch_mi"
    if measure_name != "batch_mi":
        raise NotImplementedError(
            f"measure {measure_name!r}: only batch_mi is ported")
    assignments, shard_names, filenames, types = format_rows(rows)
    ncentroids = int(assignments.max()) + 1
    v = assignments.shape[0]
    subset_size = cfg.subset.size
    if subset_size is None:
        subset_size = round((cfg.subset.ratio or 0.2) * v)
    combinations = get_cluster_pairing(types, cfg.clustering.pairing or "combination")

    batch_size = min(cfg.batch.batch_size or 20, v - 1)
    selection_size = min(cfg.batch.selection_size or 4, batch_size)
    rng = np.random.RandomState(cfg.computation.random_seed or 0)

    candidates = np.arange(v)
    if cfg.shuffle_candidates:
        rng.shuffle(candidates)
    start_indices = [int(candidates[0])]

    selector = BatchGreedySelector(
        assignments,
        combinations,
        ncentroids=ncentroids,
        batch_size=batch_size,
        selection_size=selection_size,
        keep_unselected=bool(cfg.batch.keep_unselected),
        rng=rng,
        dtype=cfg.computation.dtype or "float32",
        device=device,
    )
    # batch_mi excludes the start singleton from the output: it only seeds
    # the cache (reference batch.py:206-207)
    selected, _, _, _ = selector.run_greedy(subset_size, start_indices)
    selected = sorted(set(int(s) for s in selected))[:subset_size]
    return [
        {"filename": filenames[s], "shard_name": shard_names[s]} for s in selected
    ]


def run_single(cfg) -> Tuple[Optional[Path], int]:
    """Non-chunked path (``run.py:20-33``)."""
    device = resolve_device(cfg.computation.device)
    shard_paths = expand_shard_paths(cfg.data.path)
    partitions = load_partitions_data(shard_paths)
    metas = load_metas(cfg.data.meta.path, shard_paths)
    out_path, counts = None, 0
    for pid in sorted(partitions):
        samples = run_greedy_partition(cfg, partitions[pid], device=device)
        out_path, count = save_output_csv(samples, metas, Path(cfg.data.output.path))
        counts += count
    return out_path, counts


def run(cfg) -> Tuple[Optional[Path], int]:
    if cfg.chunk_size:
        raise NotImplementedError("chunk mode (chunk_size) is not ported yet")
    return run_single(cfg)
