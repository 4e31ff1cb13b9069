"""IO with reference-compatible schemas.

The six pipeline stages communicate only through files; schemas here are
byte-compatible with the reference so the two pipelines are mutually
resumable:

* feature/assignment shard pkls — rows
  ``{filename, shard_name, shard_size, video_features: [...],
  audio_features: [...]}`` with per-model ``{model_key, extractor_name,
  dataset, array}`` where a layer extractor's array is
  ``{layer_0: ..., layer_4: ...}``
  (``feature_extraction/code/save.py:48-76``);
* per-shard ``*_cache.pkl`` resume files with skip lists
  (``save.py:116-133``): one pickle of the shard's row list, which the port
  grows by appending each save's new rows to it (``save_shard_cache``);
* output csv rows ``shard_name,filename,id,segment``
  (``subset_selection/code/save.py:6-44``).
"""

from __future__ import annotations

import csv
import json
import os
import pickle
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# -- primitive IO ----------------------------------------------------------

def dump_pickle(data, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_json(data, path, indent: Optional[int] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=indent)
    return path


def load_json(path):
    with open(path) as f:
        return json.load(f)


# -- feature / assignment rows ---------------------------------------------

def make_feature_row(
    filename: str,
    shard_name: str,
    shard_size: int,
    per_model: Sequence[Dict],
    audio_model_keys: Sequence[str],
    name: str = "features",
) -> Dict:
    """One output row; ``per_model`` items: {model_key, extractor_name,
    dataset, array} where array is a list (layer extractor) or a vector."""
    row = {
        "filename": filename,
        "shard_name": shard_name,
        "shard_size": shard_size,
        f"video_{name}": [],
        f"audio_{name}": [],
    }
    for feat in per_model:
        arr = feat["array"]
        if isinstance(arr, (tuple, list)):
            arr = {f"layer_{i}": v for i, v in enumerate(arr)}
        entry = {
            "model_key": feat["model_key"],
            "extractor_name": feat["extractor_name"],
            "dataset": feat["dataset"],
            "array": arr,
        }
        side = "audio" if feat["model_key"] in audio_model_keys else "video"
        row[f"{side}_{name}"].append(entry)
    return row


def save_shard_output(rows: List[Dict], out_dir, shard_name: str,
                      suffix: str = ".pkl", prefix: str = "",
                      final: bool = False, cached: int = 0) -> Path:
    """Write ``rows`` as the shard's pkl; ``final`` removes its
    ``_cache.pkl``. With ``cached`` > 0 the cache holds ``rows[:cached]``,
    as ``save_shard_cache`` appended them: the rest are appended too and the
    cache is renamed into place, with nothing pickled again."""
    out_dir = Path(out_dir)
    path = out_dir / f"{prefix}{shard_name}{suffix}"
    if final and cached:
        os.replace(save_shard_cache(rows, out_dir, shard_name, appended=cached), path)
        return path
    if final:
        remove_shard_cache(out_dir, shard_name)
    return dump_pickle(rows, path)


# a protocol-3 pickle of a list opens with PROTO 3, EMPTY_LIST, BINPUT 0
_LIST_HEAD = pickle.PROTO + b"\x03" + pickle.EMPTY_LIST + pickle.BINPUT + b"\x00"


def save_shard_cache(rows: List[Dict], out_dir, shard_name: str, appended: int = 0) -> Path:
    """Save ``rows`` as the shard's ``_cache.pkl``: one protocol-3 pickle of
    the whole list, in order, which ``pickle.load`` (either package's
    ``load_shard_caches``, the reference's) reads as it stands.

    With ``appended`` > 0 the file holds ``rows[:appended]``, written by
    this function, and only the rest is pickled: their items go onto the
    list in place of its STOP byte, followed by a STOP (protocol 3 has no
    frames). Each save pickles with a fresh memo, so no item refers to
    another save's; its own memo indices, reused by a later save, are set
    again before they are read. With 0 the file is written whole."""
    path = Path(out_dir) / f"{shard_name}_cache.pkl"
    if not appended:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(rows, protocol=3))
        return path
    data = pickle.dumps(rows[appended:], protocol=3)
    if not data.startswith(_LIST_HEAD):
        raise ValueError(f"unexpected pickle of a list: {data[:8]!r}")
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        if f.read(1) != pickle.STOP:
            raise ValueError(f"{path} does not end in a pickle's STOP byte")
        f.seek(-1, os.SEEK_END)
        f.write(data[len(_LIST_HEAD):])
    return path


def remove_shard_cache(out_dir, shard_name: str) -> None:
    cache_path = Path(out_dir) / f"{shard_name}_cache.pkl"
    if cache_path.is_file():
        cache_path.unlink()


def load_shard_caches(out_dir, shard_paths: Iterable) -> Tuple[Dict, "OrderedDict"]:
    """Per-shard resume caches and skip lists (``save.py:116-133``)."""
    out_dir = Path(out_dir)
    caches: Dict[str, List[Dict]] = {}
    skip_lists: "OrderedDict[str, List[str]]" = OrderedDict()
    for shard_path in shard_paths:
        name = Path(shard_path).stem
        cache_path = out_dir / f"{name}_cache.pkl"
        if cache_path.is_file():
            cache = load_pickle(cache_path)
            caches[name] = cache
            skip_lists[name] = [row["filename"] for row in cache]
        else:
            skip_lists[name] = []
    return caches, skip_lists


# -- output csv --------------------------------------------------------------

def save_output_csv(data: List[Dict], metas: Dict, out_path,
                    name: str = "", sharded_meta: bool = True) -> Tuple[Path, int]:
    """Append selected rows to csv, joining segment metadata.

    Missing meta -> ``id='-1'``, ``segment=[-1.0, -1.0]``
    (``subset_selection/code/save.py:6-44``).
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path = out_path.parent / (name + out_path.name)
    headers = ["shard_name", "filename", "id", "segment"]
    rows_by_fname: Dict[str, Dict] = {}
    order: List[str] = []
    for row in data:
        fname = Path(row["filename"]).stem
        meta = None
        if sharded_meta:
            meta = metas.get(row["shard_name"], {}).get(fname)
        else:
            meta = metas.get(fname)
        if meta is None:
            meta = {"id": "-1", "segment": [-1.0, -1.0]}
        rows_by_fname[fname] = {**row, **meta}
        order.append(fname)
    count = 0
    with open(out_path, "a+") as f:
        writer = csv.writer(f)
        for key in order:
            row = rows_by_fname[key]
            writer.writerow([row[h] for h in headers])
            count += 1
    return out_path, count


def merge_csvs(ins: Sequence, out) -> int:
    count = 0
    with open(out, "a+") as out_f:
        for in_file in sorted(str(p) for p in ins):
            with open(in_file) as in_f:
                for line in in_f:
                    out_f.write(line)
                    count += 1
    return count
