"""Shard metadata: ``shard-XXXXXX.json`` files next to the tars.

Mirrors ``feature_extraction/code/data/meta.py:12-74``: each json is a list
of ``{filename, id, segment: [start, end]}``; we map filename stems to meta
rows, intersect with the tar's actual members, and cache the result.
"""

from __future__ import annotations

import tarfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from ..utils.io import dump_pickle, load_json, load_pickle

META_CACHE_NAME = "meta_cache.pkl"


def tar_member_stems(tar_path) -> list:
    with tarfile.open(tar_path) as tf:
        return [Path(m.name).stem for m in tf.getmembers() if m.isfile()]


def load_shard_meta(tar_path, intersect: bool = True) -> Dict[str, Dict]:
    """One shard's {stem: {filename, id, segment}} from its json."""
    tar_path = Path(tar_path)
    json_path = tar_path.with_suffix(".json")
    if not json_path.is_file():
        return {}
    rows = load_json(json_path)
    meta = {Path(row["filename"]).stem: row for row in rows}
    if intersect and tar_path.is_file():
        try:
            stems = set(tar_member_stems(tar_path))
        except Exception as e:
            # unreadable shard: drop it entirely (the reference's pervasive
            # skip-and-continue, SURVEY.md section 5)
            import warnings

            warnings.warn(f"unreadable shard {tar_path}: {e}")
            return {}
        meta = {k: v for k, v in meta.items() if k in stems}
    return meta


def load_metadata(
    shard_paths: Iterable,
    cache_dir=None,
    intersect: bool = True,
) -> Tuple[Dict[str, Dict[str, Dict]], Dict[str, int]]:
    """All shards' metas + sizes; optionally cached as meta_cache.pkl."""
    shard_paths = [Path(p) for p in shard_paths]
    cache_path = Path(cache_dir) / META_CACHE_NAME if cache_dir else None
    if cache_path is not None and cache_path.is_file():
        cached = load_pickle(cache_path)
        if set(cached["metas"]) >= {p.stem for p in shard_paths}:
            metas = {p.stem: cached["metas"][p.stem] for p in shard_paths
                     if p.stem in cached["metas"]}
            sizes = {k: len(v) for k, v in metas.items()}
            return metas, sizes
    metas = {}
    for p in shard_paths:
        meta = load_shard_meta(p, intersect=intersect)
        if meta:
            metas[p.stem] = meta
    sizes = {k: len(v) for k, v in metas.items()}
    if cache_path is not None:
        dump_pickle({"metas": metas}, cache_path)
    return metas, sizes
