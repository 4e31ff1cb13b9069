"""Stage 3 -> 4 glue: bundle clips into tar shards + shard metadata jsons,
and audit extraction outputs.

A copy of ``acav100m_tpu/pipeline/bundling.py`` (the port imports nothing of
the JAX package).

Ports of ``feature_extraction/code/bundle.sh:1-9`` (tar shard-000000.tar),
``build_metadata.py:10-20`` (shard json rows
``{filename, id, segment: [start, start+10]}``) and the fleet-scale
``feature_extraction/check_output.py`` auditor (duplicate filenames across
pkls, pkl <-> json mismatches).
"""

from __future__ import annotations

import json
import tarfile
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils.io import load_json, load_pickle


def parse_clip_filename(path) -> Tuple[str, float]:
    """``{video_id}_{start}.ext`` -> (video_id, start_seconds) — the naming
    produced by clip segmentation (``save_clip``)."""
    stem = Path(path).stem
    vid, _, start = stem.rpartition("_")
    try:
        return vid, float(start)
    except ValueError:
        return stem, 0.0


def build_shard_metadata(clip_paths: Sequence, duration: float = 10.0) -> List[Dict]:
    """[{filename, id, segment}] rows (reference build_metadata.py:10-20)."""
    rows = []
    for path in clip_paths:
        vid, start = parse_clip_filename(path)
        rows.append(
            {
                "filename": Path(path).name,
                "id": vid,
                "segment": [start, start + duration],
            }
        )
    return rows


def bundle_shards(
    clip_paths: Sequence,
    out_dir,
    shard_size: int = 1000,
    start_index: int = 0,
    duration: float = 10.0,
) -> List[Path]:
    """Tar clips into shard-XXXXXX.tar + .json pairs (bundle.sh semantics)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    clip_paths = sorted(Path(p) for p in clip_paths)
    shards = []
    for si, base in enumerate(range(0, len(clip_paths), shard_size)):
        chunk = clip_paths[base : base + shard_size]
        name = f"shard-{start_index + si:06d}"
        tar_path = out_dir / f"{name}.tar"
        with tarfile.open(tar_path, "w") as tf:
            for clip in chunk:
                tf.add(clip, arcname=clip.name)
        meta = build_shard_metadata(chunk, duration)
        (out_dir / f"{name}.json").write_text(json.dumps(meta))
        shards.append(tar_path)
    return shards


def check_output(features_dir, meta_dir=None, name: str = "features") -> Dict:
    """Audit extraction outputs (reference check_output.py):

    * duplicate filenames across output pkls;
    * pkl rows missing from the shard json / json rows missing from pkls;
    * per-shard completeness ratios.
    """
    features_dir = Path(features_dir)
    meta_dir = Path(meta_dir) if meta_dir else features_dir
    report: Dict = {"shards": {}, "duplicates": [], "ok": True}
    seen: Counter = Counter()
    for pkl_path in sorted(features_dir.glob("shard-*.pkl")):
        if pkl_path.name.endswith("_cache.pkl"):
            continue
        shard_name = pkl_path.stem
        rows = load_pickle(pkl_path)
        fnames = [row["filename"] for row in rows]
        seen.update(fnames)
        entry = {"rows": len(rows)}
        json_path = meta_dir / f"{shard_name}.json"
        if json_path.is_file():
            meta = load_json(json_path)
            meta_names = {m["filename"] for m in meta}
            row_names = set(fnames)
            entry["meta_rows"] = len(meta_names)
            entry["missing_from_pkl"] = sorted(meta_names - row_names)
            entry["extra_in_pkl"] = sorted(row_names - meta_names)
            entry["complete_ratio"] = (
                len(row_names & meta_names) / max(len(meta_names), 1)
            )
            if entry["extra_in_pkl"]:
                report["ok"] = False
        report["shards"][shard_name] = entry
    report["duplicates"] = sorted(f for f, c in seen.items() if c > 1)
    if report["duplicates"]:
        report["ok"] = False
    return report
