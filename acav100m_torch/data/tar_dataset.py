"""Streaming tar shard dataset and batched feed.

The in-process parts of ``acav100m_tpu/data/tar_dataset.py``, copied (the
port imports nothing of the JAX package):

* stream tar members shard by shard, join shard metadata, honor per-shard
  skip lists (resume);
* decode + prepare each clip (errors skip and continue, the reference's
  ``warn_and_continue``);
* assemble static-shape batches (pad the tail batch and mask) behind a
  background prefetch thread.

Pooled decode workers and lock-step padding are not ported.
"""

from __future__ import annotations

import queue
import tarfile
import threading
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .video import decode_npz, prepare_clip


class TarShardDataset:
    """Iterates {filename, shard_name, shard_size, **clip arrays}."""

    def __init__(
        self,
        shard_paths: Sequence,
        metas: Dict[str, Dict[str, Dict]],
        skip_lists: Optional[Dict[str, List[str]]] = None,
        decoder: Callable[[bytes], Optional[Dict]] = decode_npz,
        prepare: Callable[[Optional[Dict]], Optional[Dict]] = prepare_clip,
        on_error: str = "continue",
    ):
        self.shard_paths = [Path(p) for p in shard_paths]
        self.metas = metas
        self.skip_lists = skip_lists or {}
        self.decoder = decoder
        self.prepare = prepare
        self.on_error = on_error

    @staticmethod
    def _iter_members(shard_path):
        with tarfile.open(shard_path) as tf:
            for member in tf:
                if member.isfile():
                    yield member.name, tf.extractfile(member).read()

    def __iter__(self) -> Iterator[Dict]:
        for shard_path in self.shard_paths:
            shard_name = shard_path.stem
            meta = self.metas.get(shard_name, {})
            shard_size = len(meta)
            skip = set(self.skip_lists.get(shard_name, []))
            try:
                for member_name, data in self._iter_members(shard_path):
                    fname = Path(member_name).name
                    stem = Path(member_name).stem
                    if stem not in meta or fname in skip:
                        continue
                    try:
                        clip = self.prepare(self.decoder(data))
                    except Exception as e:
                        if self.on_error == "raise":
                            raise
                        warnings.warn(f"decode failed for {fname}: {e}")
                        continue
                    if clip is None:
                        continue
                    yield {
                        "filename": fname,
                        "shard_name": shard_name,
                        "shard_size": shard_size,
                        **clip,
                    }
            except Exception as e:  # skip-and-continue per shard
                if self.on_error == "raise":
                    raise
                warnings.warn(f"failed to read shard {shard_path}: {e}")
                continue


def collate(samples: List[Dict], batch_size: int) -> Dict:
    """Stack a (possibly short) list of samples into a batch padded to
    ``batch_size`` with zeros; ``batch_mask`` marks real rows."""
    n = len(samples)
    if not 0 < n <= batch_size:
        raise ValueError(f"cannot collate {n} samples into a batch of {batch_size}")
    pad = batch_size - n
    batch = {
        "filename": [s["filename"] for s in samples] + [""] * pad,
        "shard_name": [s["shard_name"] for s in samples] + [""] * pad,
        "shard_size": [s["shard_size"] for s in samples] + [0] * pad,
        "batch_mask": np.asarray([True] * n + [False] * pad),
    }
    for key in ("frames", "audio", "valid_samples"):
        if key in samples[0]:
            arrs = [np.asarray(s[key]) for s in samples]
            arrs += [np.zeros_like(arrs[0])] * pad
            batch[key] = np.stack(arrs)
    return batch


def batched(source: Iterable[Dict], batch_size: int) -> Iterator[Dict]:
    buf: List[Dict] = []
    for sample in source:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate(buf, batch_size)
            buf = []
    if buf:
        yield collate(buf, batch_size)


class Prefetcher:
    """Runs ``source`` on a background thread, ``depth`` items ahead."""

    _SENTINEL = object()

    def __init__(self, source: Iterable, depth: int = 2):
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(
            target=self._fill, args=(iter(source),), daemon=True
        )
        self.thread.start()

    def _fill(self, it):
        try:
            for item in it:
                self.queue.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self.error = e
        finally:
            self.queue.put(self._SENTINEL)

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                return
            yield item


def make_loader(
    shard_paths: Sequence,
    metas: Dict,
    batch_size: int,
    skip_lists: Optional[Dict] = None,
    decoder: Callable = decode_npz,
    prepare: Callable = prepare_clip,
    prefetch: int = 2,
    num_workers: int = 0,
) -> Iterable[Dict]:
    """Batched clip loader, decoded in-process (``num_workers=0``) behind a
    prefetch thread."""
    if num_workers:
        raise NotImplementedError("pooled decode workers are not ported; "
                                  "use computation.num_workers=0")
    batches = batched(TarShardDataset(shard_paths, metas, skip_lists, decoder,
                                      prepare), batch_size)
    if prefetch:
        return Prefetcher(batches, depth=prefetch)
    return batches
