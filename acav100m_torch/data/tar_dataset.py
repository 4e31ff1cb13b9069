"""Streaming tar shard dataset and batched feed.

A copy of ``acav100m_tpu/data/tar_dataset.py`` (the port imports nothing of
the JAX package):

* stream tar members shard by shard (the native header walk of
  ``native_tar`` where it builds, else ``tarfile``), join shard metadata,
  honor per-shard skip lists (resume);
* decode + prepare each clip (errors skip and continue, the reference's
  ``warn_and_continue``);
* with ``num_workers`` > 0, decode in spawned worker processes that hand
  samples over through shared memory, requeuing a dead worker's unfinished
  shards;
* assemble static-shape batches (pad the tail batch and mask) behind a
  background prefetch thread.

Nothing here imports torch: a spawned worker starts from a fresh import of
this module and must never touch the parent's CUDA context. Lock-step
padding across processes (``empty_batch``, ``pad_to_length``) is not
ported.
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
        """(filename, bytes) pairs; the native header walk where
        ``libtario`` builds, else Python tarfile."""
        from . import native_tar

        index = native_tar.index_tar(shard_path) if native_tar.available() else None
        if index is not None:
            for name, offset, size in index:
                data = native_tar.read_member(shard_path, offset, size)
                if data is not None:
                    yield name, data
            return
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


def _sample_to_shm(sample: Dict) -> Dict:
    """Move a decoded sample's arrays into a SharedMemory segment; return a
    small picklable descriptor.

    A worker hard-killed mid-write could tear a multi-MB pickled sample in
    the queue's pipe, and the consumer would then block forever on the
    missing bytes. Pipe writes up to PIPE_BUF are atomic, so the queue
    carries only this sub-KB descriptor and the ~6 MB of frames and audio
    ride shared memory.
    """
    from multiprocessing import shared_memory

    arrays = {k: np.asarray(v) for k, v in sample.items()
              if isinstance(v, np.ndarray) or k in ("frames", "audio", "valid_samples")}
    total = sum(int(a.nbytes) for a in arrays.values())
    meta = {k: v for k, v in sample.items() if k not in arrays}
    if total == 0:
        return {"meta": meta, "shm": None, "layout": []}
    shm = shared_memory.SharedMemory(create=True, size=total)
    layout = []
    offset = 0
    for key, arr in arrays.items():
        view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf, offset=offset)
        view[...] = arr
        layout.append((key, str(arr.dtype), arr.shape, offset))
        offset += int(arr.nbytes)
    name = shm.name
    shm.close()
    return {"meta": meta, "shm": name, "layout": layout}


def _sample_from_shm(payload: Dict) -> Dict:
    """Rebuild a sample from its descriptor; copies out and unlinks."""
    from multiprocessing import shared_memory

    sample = dict(payload["meta"])
    if payload["shm"] is None:
        return sample
    shm = shared_memory.SharedMemory(name=payload["shm"])
    try:
        for key, dtype, shape, offset in payload["layout"]:
            view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf, offset=offset)
            sample[key] = np.array(view)  # own the memory past unlink
    finally:
        shm.close()
        shm.unlink()
    return sample


def _stream_worker(wid, shard_paths, metas, skip_lists, decoder, prepare, q):
    """Persistent decode worker (a spawned process): streams its shards
    sample by sample onto the shared bounded queue, with ``shard_done``
    after each completed shard so the consumer can requeue only the
    unfinished rest on failure."""
    try:
        for shard_path in shard_paths:
            ds = TarShardDataset([shard_path], metas, skip_lists, decoder, prepare)
            for sample in ds:
                q.put(("sample", _sample_to_shm(sample)))
            q.put(("shard_done", (wid, Path(shard_path).stem)))
    except Exception as e:  # reported to the consumer, which requeues
        q.put(("error", (wid, f"{type(e).__name__}: {e}")))
    finally:
        q.put(("done", wid))


def _pooled_stream(
    shard_paths: Sequence,
    metas: Dict,
    skip_lists: Optional[Dict],
    decoder: Callable,
    prepare: Callable,
    num_workers: int,
    buffer_samples: int,
    shard_retries: int = 2,
    poll_interval: float = 1.0,
) -> Iterator[Dict]:
    """Stream samples from ``num_workers`` persistent decode processes.

    At most ``buffer_samples`` decoded clips wait in the queue (each a
    shared-memory segment, ~6.3 MB at production shapes), whatever the
    shard size. Arrival is unordered across workers, as with the
    reference's DataLoader workers.

    When a worker reports an error, or dies without a word (found by
    polling its liveness), its unfinished shards are requeued onto a new
    worker, the partly streamed shard resumed exactly once through a skip
    list of the filenames already delivered. A shard that fails
    ``shard_retries`` workers in a row is dropped with a warning.
    """
    import multiprocessing as mp
    import queue as queue_mod
    from collections import defaultdict

    from ..utils.shards import worker_selection

    # spawn, never fork: the parent holds a CUDA context and threads
    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=max(buffer_samples, 1))
    workers: Dict[int, Dict] = {}
    yielded: Dict[str, set] = defaultdict(set)
    retry_counts: Dict[str, int] = defaultdict(int)
    next_wid = 0

    def launch(sub_paths):
        nonlocal next_wid
        wid = next_wid
        next_wid += 1
        skips = {
            name: list(set(skip_lists.get(name, []) if skip_lists else [])
                       | yielded[name])
            for name in {Path(p).stem for p in sub_paths}
        }
        p = ctx.Process(
            target=_stream_worker,
            args=(wid, list(sub_paths), metas, skips, decoder, prepare, q),
            daemon=True,
        )
        p.start()
        workers[wid] = {"proc": p, "shards": list(sub_paths),
                        "completed": set(), "done": False}

    def handle_failure(wid, reason):
        st = workers[wid]
        if st["done"]:
            return
        st["done"] = True
        unfinished = [
            p for p in st["shards"] if Path(p).stem not in st["completed"]
        ]
        requeue = []
        for p in unfinished:
            retry_counts[Path(p).stem] += 1
            if retry_counts[Path(p).stem] > shard_retries:
                warnings.warn(
                    f"shard {Path(p).stem} dropped after {shard_retries} "
                    f"failed decode workers (poison shard?)"
                )
            else:
                requeue.append(p)
        warnings.warn(
            f"decode worker {wid} failed ({reason}); requeuing "
            f"{len(requeue)} unfinished shard(s)"
        )
        if requeue:
            launch(requeue)

    for w in range(num_workers):
        launch(worker_selection(list(shard_paths), w, num_workers))

    try:
        while any(not st["done"] for st in workers.values()):
            try:
                kind, payload = q.get(timeout=poll_interval)
            except queue_mod.Empty:
                for wid, st in list(workers.items()):
                    if not st["done"] and not st["proc"].is_alive():
                        handle_failure(wid, "process died without reporting")
                continue
            if kind == "sample":
                sample = _sample_from_shm(payload)
                yielded[sample["shard_name"]].add(sample["filename"])
                yield sample
            elif kind == "shard_done":
                wid, shard_name = payload
                workers[wid]["completed"].add(shard_name)
            elif kind == "error":
                wid, msg = payload
                handle_failure(wid, msg)
            else:  # done
                workers[payload]["done"] = True
    finally:
        for st in workers.values():
            p = st["proc"]
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        # unlink the segments of samples never delivered (the consumer left
        # early); those of killed workers are reclaimed by multiprocessing's
        # resource tracker when the process ends
        from multiprocessing import shared_memory

        try:
            while True:
                kind, payload = q.get_nowait()
                if kind == "sample" and payload.get("shm"):
                    try:
                        seg = shared_memory.SharedMemory(name=payload["shm"])
                        seg.close()
                        seg.unlink()
                    except FileNotFoundError:
                        pass
        except queue_mod.Empty:
            pass
        q.close()


def make_loader(
    shard_paths: Sequence,
    metas: Dict,
    batch_size: int,
    skip_lists: Optional[Dict] = None,
    decoder: Callable = decode_npz,
    prepare: Callable = prepare_clip,
    prefetch: int = 2,
    num_workers: int = 0,
    buffer_samples: int = 32,
) -> Iterable[Dict]:
    """Batched clip loader.

    ``num_workers`` > 0 decodes the shards in that many spawned worker
    processes (at most one per shard; shards split round-robin as in the
    reference's ``worker_urls``), which stream samples through a queue of
    at most ``buffer_samples`` clips. ``decoder`` and ``prepare`` must then
    pickle: a decoder instance or module-level function, a
    ``functools.partial`` of ``prepare_clip``. With 0 workers or a single
    shard, decoding runs in-process. Either way a background thread keeps
    ``prefetch`` batches ahead.
    """
    if num_workers > 0 and len(shard_paths) > 1:
        num_workers = min(num_workers, len(shard_paths))
        source = _pooled_stream(shard_paths, metas, skip_lists, decoder, prepare,
                                num_workers, buffer_samples)
    else:
        source = TarShardDataset(shard_paths, metas, skip_lists, decoder, prepare)
    batches = batched(source, batch_size)
    if prefetch:
        return Prefetcher(batches, depth=prefetch)
    return batches
