"""Shard planning: which host/device processes which tar/pkl shards.

Reimplements the placement semantics of the reference's
``mps/distributed.py`` (``node_selection``
``feature_extraction/code/mps/distributed.py:422-441``, ``worker_urls``
``:404-419``, ``get_length`` ``:444-461``) without torch.distributed: the
"rank" is a host/device index chosen by the caller, not ambient process
state. A copy of ``acav100m_tpu/utils/shards.py``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .braceexpand import braceexpand


def node_selection(
    full_urls: Sequence,
    index: int,
    total: int,
    is_train: bool = False,
) -> List:
    """Round-robin shard placement ``urls[index::total]``.

    ``is_train=True`` reproduces the reference's wrap-around mode where every
    rank iterates ALL shards but starting at a rank-dependent offset, so
    global iteration order differs per rank while coverage is complete
    (``mps/distributed.py:432-438``).
    """
    full_urls = list(full_urls)
    if index == 0 and total > len(full_urls):
        warnings.warn(f"num_processes {total} > num_shards {len(full_urls)}")
    if is_train:
        wrap_around = [x % total for x in range(index, index + total)]
        urls: List = []
        for i in wrap_around:
            urls += full_urls[i::total]
        return urls
    return full_urls[index::total]


def worker_selection(urls: Sequence, worker_id: int, num_workers: int) -> List:
    """Per-data-worker subset of a node's shards (``worker_urls``)."""
    urls = list(urls)
    if worker_id == 0 and len(urls) < num_workers:
        warnings.warn(f"num_workers {num_workers} > num_shards {len(urls)}")
    return urls[worker_id::num_workers]


def get_num_workers(num_workers: int, num_shards: int) -> Tuple[int, int]:
    if num_workers > num_shards:
        num_workers = num_shards
    return num_workers, (1 if num_workers == 0 else num_workers)


def get_length(
    shards_size: Sequence[int],
    batch_size: int,
    num_workers: int,
    total: int,
    is_train: bool = False,
) -> int:
    """Global per-rank iteration length so all ranks step in lock-step.

    Mirrors ``mps/distributed.py:444-461``: the max over ranks/workers of
    ceil(samples/batch) — every rank must run the same number of steps or a
    collective would deadlock; with XLA collectives the same constraint
    holds inside a pjit'd loop.
    """
    shards_size = list(shards_size)
    node_iters = []
    for rank in range(total):
        node_sizes = shards_size if is_train else shards_size[rank::total]
        _, eff_workers = get_num_workers(num_workers, len(node_sizes))
        worker_iters = [
            math.ceil(sum(node_sizes[wid::eff_workers]) / batch_size)
            for wid in range(eff_workers)
        ]
        node_iters.append(max(worker_iters) if worker_iters else 0)
    return max(node_iters) * batch_size


def plan_shards(
    path,
    index: int = 0,
    total: int = 1,
    suffix: str = ".tar",
    discard_remainder: bool = False,
    keep_fn: Optional[Callable[[str], bool]] = None,
    is_train: bool = False,
) -> Tuple[List[str], List[str]]:
    """Expand a brace shard spec and place shards on this rank.

    Returns ``(this_rank_shards, all_shards)``. Mirrors
    ``feature_extraction/code/data/shards.py:16-39``: brace expansion,
    optional drop-remainder so shards divide evenly over ``total``, optional
    keep-filter (e.g. only shards with metadata json), then round-robin
    placement.
    """
    # NB: Path.stem would truncate at dots inside a brace group, so strip
    # the suffix textually before re-appending it.
    spec = str(path)
    if suffix and spec.endswith(suffix):
        spec = spec[: -len(suffix)]
    spec = spec + suffix
    all_shards = sorted(braceexpand(spec))
    if discard_remainder:
        keep = total * (len(all_shards) // total)
        if keep != len(all_shards):
            warnings.warn(
                f"num_shards {len(all_shards)} not divisible by {total}; "
                f"dropping last {len(all_shards) - keep}"
            )
        all_shards = all_shards[:keep]
    if keep_fn is not None:
        all_shards = [p for p in all_shards if keep_fn(p)]
    mine = node_selection(all_shards, index=index, total=total, is_train=is_train)
    return mine, all_shards


def shard_name(path) -> str:
    return Path(path).stem
