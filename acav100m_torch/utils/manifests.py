"""Run manifests: ``log_{hostname}_{pid}_{timestamp}.json``.

These manifests are load-bearing in the reference: subset selection groups
assignment shards into partitions by which clustering run produced them,
so clips are only compared within a consistent clustering
(``feature_extraction/code/save.py:10-18``, ``utils.py:55-70``,
``subset_selection/code/dataloader.py:72-89``). Schema and file naming are
kept identical so outputs are mutually resumable with the reference.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def get_run_info() -> Dict:
    return {
        "hostname": platform.uname()[1],
        "pid": os.getpid(),
        "timestamp": int(time.time()),
        "time": str(datetime.datetime.now()),
    }


def get_run_id(run_info: Optional[Dict] = None) -> str:
    if run_info is None:
        run_info = get_run_info()
    return "_".join(
        str(run_info[k]) for k in ("hostname", "pid", "timestamp") if k in run_info
    )


def write_run_manifest(out_dir, saved_paths: Sequence, run_info: Optional[Dict] = None):
    """Write ``log_{run_id}.json`` listing shard stems produced by this run."""
    saved_paths = list(saved_paths)
    if not saved_paths:
        return None
    if run_info is None:
        run_info = get_run_info()
    names = [Path(p).stem for p in saved_paths]
    out_path = Path(out_dir) / f"log_{get_run_id(run_info)}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({**run_info, "shards": names}, f)
    return out_path


def read_run_manifests(shards_dir) -> Dict[str, int]:
    """Map shard stem -> partition index, newer manifests winning.

    Mirrors ``subset_selection/code/dataloader.py:72-89``: logs are sorted
    by the trailing timestamp in the filename and later logs overwrite the
    partition assignment of shards they mention.
    """
    log_paths = sorted(
        Path(shards_dir).glob("log_*.json"),
        key=lambda x: str(x).split(".")[-2].split("_")[-1],
    )
    partitions: Dict[str, int] = {}
    for i, log_path in enumerate(log_paths):
        with open(log_path) as f:
            log = json.load(f)
        for shard in log.get("shards", []):
            partitions[shard] = i
    return partitions
