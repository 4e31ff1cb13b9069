"""Stage 6 — greedy pairwise-MI subset selection.

Port of ``acav100m_tpu/pipeline/subset_selection.py`` (reference
``subset_selection/code/{run.py,run_greedy.py,dataloader.py,save.py}``)
with the same config keys, defaults and ``output.csv``:

* assignment pkl shards are grouped into partitions by ``log_*.json`` run
  manifests (newer logs win; shards without logs -> partition -1);
* per partition: the assignment matrix (V x D, clustering types sorted),
  the cluster pairing (default ``combination`` = C(D,2)), batched greedy MI
  maximization (B=20, k=4, keep_unselected) down to ``subset.ratio``=0.2;
* csv rows ``shard_name,filename,id,segment`` joined from the shard jsons;
* ``measure_name``: ``batch_mi`` (the default), or ``mi``, ``ami``, ``nmi``
  and ``mem_mi`` through the whole-pool ``GreedySelector`` (full-table
  scores; ``mem_mi`` is MI scored incrementally);
* chunk mode: shards split into chunks of ``chunk_size``, each selected
  independently with per-chunk subset size ``ceil(size/num_chunks)``,
  per-chunk cache csvs in ``caches/``, merged into ``data.output.path``
  (and by the ``reduce`` verb).

``computation.dtype`` ``float64`` runs the contingency cache and the scores
in float64, the reference's own precision; ``bfloat16`` runs them in bf16,
rounded at every op, as the JAX package does. ``compare_measures`` and
``compare_dtypes`` cross-check two measures and the two precisions.
"""

from __future__ import annotations

import math
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config, build_config
from ..device import resolve_device
from ..ops.mi import BatchGreedySelector, GreedySelector
from ..ops.pairing import get_cluster_pairing
from ..utils.braceexpand import braceexpand
from ..utils.io import load_json, load_pickle, merge_csvs, save_output_csv
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

    measure_name = cfg.measure_name or "batch_mi"
    dtype = cfg.computation.dtype or "float32"
    if measure_name == "batch_mi":
        selector = BatchGreedySelector(
            assignments,
            combinations,
            ncentroids=ncentroids,
            batch_size=batch_size,
            selection_size=selection_size,
            keep_unselected=bool(cfg.batch.keep_unselected),
            rng=rng,
            dtype=dtype,
            device=device,
        )
        # batch_mi excludes the start singleton from the output: it only
        # seeds the cache (reference batch.py:206-207)
        selected, _, _, _ = selector.run_greedy(subset_size, start_indices)
    elif measure_name in ("mi", "ami", "nmi", "mem_mi"):
        kind = "mi" if measure_name == "mem_mi" else measure_name
        scorer = "mem" if measure_name == "mem_mi" else "full"
        selector = GreedySelector(assignments, combinations, ncentroids=ncentroids,
                                  kind=kind, scorer=scorer, dtype=dtype, device=device)
        # stage 6's pool greedy never folds the start singleton into the
        # cache (reference mi.py:150-173): it only takes an output slot
        selected, _, _, _ = selector.run_greedy(subset_size, start_indices,
                                                fold_start=False)
    else:
        raise ValueError(f"unknown measure {measure_name!r}")
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


def get_chunks(paths: Sequence, chunk_size: int):
    for i in range(0, len(paths), chunk_size):
        yield list(paths[i : i + chunk_size])


def run_chunks(cfg, _trace: Optional[list] = None) -> Tuple[Path, int]:
    """Chunk mode (``chunk.py:21-140``): independent selection per chunk of
    shards into ``caches/cache_{pid}_0_{i}_{name}``, skipping chunks whose
    cache csv exists, then a merge into ``data.output.path``.

    The next chunk's pkls load on a background thread while the current
    chunk selects (the reference's ThreadPoolExecutor overlap,
    ``chunk.py:196-226``). ``_trace`` collects (event, chunk_index, t)
    tuples: when each chunk's load and selection started and ended.
    """
    device = resolve_device(cfg.computation.device)
    shard_paths = expand_shard_paths(cfg.data.path)
    chunks = list(get_chunks(shard_paths, int(cfg.chunk_size)))
    num_chunks = len(chunks)
    out_path = Path(cfg.data.output.path)
    cache_dir = out_path.parent / "caches"
    cache_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()

    chunk_cfg = cfg.copy()
    if isinstance(cfg.subset.size, int):
        chunk_cfg.subset.size = math.ceil(cfg.subset.size / num_chunks)

    def trace(event, i):
        if _trace is not None:
            _trace.append((event, i, time.time()))

    def load_chunk(i, chunk):
        trace("load_start", i)
        partitions = load_partitions_data(chunk)
        metas = load_metas(cfg.data.meta.path, chunk)
        trace("load_done", i)
        return partitions, metas

    cache_csvs = [
        cache_dir / f"cache_{pid}_0_{i}_{out_path.name}" for i in range(num_chunks)
    ]
    pending = [i for i in range(num_chunks) if not cache_csvs[i].is_file()]
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(load_chunk, pending[0], chunks[pending[0]]) if pending else None
        for j, i in enumerate(pending):
            partitions, metas = nxt.result()
            if j + 1 < len(pending):  # prefetch while this chunk selects
                n = pending[j + 1]
                nxt = pool.submit(load_chunk, n, chunks[n])
            trace("select_start", i)
            for k in sorted(partitions):
                samples = run_greedy_partition(chunk_cfg, partitions[k], device=device)
                save_output_csv(samples, metas, cache_csvs[i])
            trace("select_done", i)
    count = merge_csvs(cache_csvs, out_path)
    return out_path, count


def run(cfg) -> Tuple[Optional[Path], int]:
    if cfg.chunk_size:
        return run_chunks(cfg)
    return run_single(cfg)


def compare_measures(cfg, measures: Sequence[str] = ("mi", "mem_mi")) -> Dict:
    """Run two measures' greedy selectors on the same partitions (port of
    ``subset_selection/code/tests.py:10-46``) on ``computation.device`` and
    report per-element selection equality and gain deltas.

    The selectors fold a start sample (``fold_start=True``): from an empty
    cache every candidate's first score ties in exact arithmetic and two
    correct implementations would diverge on rounding alone."""
    device = resolve_device(cfg.computation.device)
    partitions = load_partitions_data(expand_shard_paths(cfg.data.path))
    report: Dict = {"partitions": {}}
    for pid in sorted(partitions):
        assignments, _, _, types = format_rows(partitions[pid])
        ncentroids = int(assignments.max()) + 1
        v = assignments.shape[0]
        subset_size = cfg.subset.size or round((cfg.subset.ratio or 0.2) * v)
        combos = get_cluster_pairing(types, cfg.clustering.pairing or "combination")
        results = {}
        for name in measures:
            kind = "mi" if name == "mem_mi" else name
            scorer = "mem" if name == "mem_mi" else "full"
            sel = GreedySelector(assignments, combos, ncentroids=ncentroids,
                                 kind=kind, scorer=scorer, device=device)
            s, gains, _, _ = sel.run_greedy(subset_size + 1, [0])
            results[name] = (s[:subset_size], gains[:subset_size])
        (s_a, g_a), (s_b, g_b) = results[measures[0]], results[measures[1]]
        same = [x == y for x, y in zip(s_a, s_b)]
        gain_diff = [abs(x - y) for x, y in zip(g_a, g_b)]
        report["partitions"][pid] = {
            "selection_equal_ratio": float(np.mean(same)) if same else 1.0,
            "max_gain_diff": float(max(gain_diff)) if gain_diff else 0.0,
            "subset_size": subset_size,
        }
    return report


def compare_dtypes(
    assignments: np.ndarray,
    combinations,
    ncentroids: int,
    subset_size: int,
    batch_size: int = 20,
    selection_size: int = 4,
    keep_unselected: bool = True,
    seed: int = 0,
    device="cuda",
) -> Dict:
    """float32 against float64 selection drift: the production batch greedy
    twice on the same candidate order, reporting the rounds whose winner
    sets differ (flips), the final subset overlap and the gains' largest
    difference."""
    device = resolve_device(device)
    runs = {}
    for dtype in ("float32", "float64"):
        sel = BatchGreedySelector(
            assignments, combinations, ncentroids=ncentroids,
            batch_size=batch_size, selection_size=selection_size,
            keep_unselected=keep_unselected,
            rng=np.random.RandomState(seed), dtype=dtype, device=device,
        )
        selected, gains, _, _ = sel.run_greedy(subset_size, [0])
        runs[dtype] = (selected, gains)
    (s32, g32), (s64, g64) = runs["float32"], runs["float64"]
    n = min(len(s32), len(s64))
    rounds32 = [set(s32[i : i + selection_size]) for i in range(0, n, selection_size)]
    rounds64 = [set(s64[i : i + selection_size]) for i in range(0, n, selection_size)]
    flips = sum(a != b for a, b in zip(rounds32, rounds64))
    overlap = len(set(s32) & set(s64)) / max(1, len(set(s64)))
    gdiff = [abs(a - b) for a, b in zip(g32, g64)]
    return {
        "rounds": len(rounds64),
        "flip_rounds": int(flips),
        "flip_rate": flips / max(1, len(rounds64)),
        "subset_overlap": float(overlap),
        "positionwise_equal": float(np.mean([a == b for a, b in zip(s32, s64)])),
        "max_gain_diff": float(max(gdiff)) if gdiff else 0.0,
        "subset_size": subset_size,
    }
