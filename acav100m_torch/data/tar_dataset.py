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
  background prefetch thread, each sample written once into the batch's
  arrays, whose allocator the caller picks (pinned memory for the card);
* pad a process's batches with all-masked ones up to a count shared by all
  processes (``pad_to_length``), so data-parallel ranks step in lock-step.

Nothing here imports torch: a spawned worker starts from a fresh import of
this module and must never touch the parent's CUDA context.
"""

from __future__ import annotations

import itertools
import queue
import tarfile
import threading
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .. import tracing
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
                        with tracing.span("span.extract.decode"):
                            decoded = self.decoder(data)
                        with tracing.span("span.extract.prepare"):
                            clip = self.prepare(decoded)
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


def collate(samples: List[Dict], batch_size: int, empty: Callable = np.empty) -> Dict:
    """Stack a (possibly short) list of samples into a batch padded to
    ``batch_size`` with zeros; ``batch_mask`` marks real rows. Each array
    of the batch comes from ``empty(shape, dtype)`` and each sample is
    written into it once (``np.stack``'s values and dtype)."""
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
            if any(a.shape != arrs[0].shape for a in arrs):
                raise ValueError(f"cannot collate {key} of shapes {[a.shape for a in arrs]}")
            out = empty((batch_size, *arrs[0].shape), np.result_type(*arrs))
            for i, a in enumerate(arrs):
                out[i] = a
            out[n:] = 0
            batch[key] = out
    return batch


def batched(source: Iterable[Dict], batch_size: int,
            empty: Callable = np.empty) -> Iterator[Dict]:
    """Batches of ``batch_size`` samples (``collate`` with ``empty``), the
    last one short. Batch n's decoding and collation run in its
    ``span.extract.load`` (unit n)."""
    samples = iter(source)
    for n in itertools.count():
        with tracing.span("span.extract.load", unit=n):
            buf = list(itertools.islice(samples, batch_size))
            if not buf:
                return
            with tracing.span("span.extract.collate"):
                batch = collate(buf, batch_size, empty)
            for sample in buf:
                _close_shm(sample)
        yield batch


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
    small picklable descriptor: the worker's pipe carries that, and the
    ~6 MB of frames and audio are written once and read once instead of
    pickled through the pipe."""
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
    """Rebuild a sample from its descriptor. Its arrays view the segment,
    whose name is unlinked at once (the mapping lives on with the views),
    so ``collate`` reads them where the worker wrote them; ``_close_shm``
    then closes the segment (key ``_shm``)."""
    from multiprocessing import shared_memory

    sample = dict(payload["meta"])
    if payload["shm"] is None:
        return sample
    shm = shared_memory.SharedMemory(name=payload["shm"])
    shm.unlink()
    for key, dtype, shape, offset in payload["layout"]:
        sample[key] = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf, offset=offset)
    sample["_shm"] = shm  # the last key: a dropped sample releases its views first
    return sample


def _close_shm(sample: Dict) -> None:
    """Drop a ``_sample_from_shm`` sample's views and close its segment; a
    sample without one is left as it is."""
    shm = sample.pop("_shm", None)
    if shm is None:
        return
    for key in [k for k, v in sample.items() if isinstance(v, np.ndarray)]:
        del sample[key]
    shm.close()


def _stream_worker(wid, shard_paths, metas, skip_lists, decoder, prepare, conn, slots):
    """Persistent decode worker (a spawned process): streams its shards
    sample by sample down its own pipe, taking one of ``slots`` for each
    sample (the consumer gives it back on receipt), with ``shard_done``
    after each completed shard so the consumer can requeue only the
    unfinished rest on failure."""
    try:
        for shard_path in shard_paths:
            ds = TarShardDataset([shard_path], metas, skip_lists, decoder, prepare)
            for sample in ds:
                slots.acquire()
                conn.send(("sample", _sample_to_shm(sample)))
            conn.send(("shard_done", (wid, Path(shard_path).stem)))
    except Exception as e:  # reported to the consumer, which requeues
        conn.send(("error", (wid, f"{type(e).__name__}: {e}")))
    finally:
        conn.send(("done", wid))
        conn.close()


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

    Each worker writes to a pipe of its own, with at most
    ``buffer_samples // num_workers`` decoded clips (each a shared-memory
    segment, ~6.3 MB at production shapes) sent and not yet received,
    whatever the shard size: a semaphore of its own counts them. The
    consumer holds no copy of a worker's write end, so a worker that dies,
    even in the middle of a message, leaves end of file on its pipe, and
    nothing a dying worker holds is shared with another worker. (One
    ``Queue`` shared by all workers is not safe: a worker killed while its
    feeder thread holds the queue's write lock leaves that lock taken for
    good, and every other writer blocks while staying alive.) Arrival is
    unordered across workers, as with the reference's DataLoader workers.

    When a worker reports an error, or its pipe ends before its ``done``,
    what it sent before is read, then its unfinished shards are requeued
    onto a new worker, the partly streamed shard resumed exactly once
    through a skip list of the filenames already delivered. A shard that
    fails ``shard_retries`` workers in a row is dropped with a warning.
    """
    import multiprocessing as mp
    from collections import defaultdict
    from multiprocessing import shared_memory
    from multiprocessing.connection import wait

    from ..utils.shards import worker_selection

    # spawn, never fork: the parent holds a CUDA context and threads
    ctx = mp.get_context("spawn")
    per_worker = max(buffer_samples // num_workers, 1)
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
        reader, writer = ctx.Pipe(duplex=False)
        slots = ctx.BoundedSemaphore(per_worker)
        p = ctx.Process(
            target=_stream_worker,
            args=(wid, list(sub_paths), metas, skips, decoder, prepare, writer, slots),
            daemon=True,
        )
        p.start()
        writer.close()  # the worker's copy is the only one: its death is EOF
        workers[wid] = {"proc": p, "conn": reader, "slots": slots,
                        "shards": list(sub_paths), "completed": set(), "done": False}

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

    def received(conn):
        """The whole messages on ``conn`` now, without blocking on a new
        one; then None once the pipe has ended (EOF, or a message cut
        short by its writer's death)."""
        while conn.poll():
            try:
                yield conn.recv()
            except (EOFError, OSError):
                yield None
                return

    def unlink(payload):
        if payload.get("shm"):
            try:
                seg = shared_memory.SharedMemory(name=payload["shm"])
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass

    for w in range(num_workers):
        launch(worker_selection(list(shard_paths), w, num_workers))

    try:
        while any(not st["done"] for st in workers.values()):
            wait([st["conn"] for st in workers.values() if not st["done"]],
                 timeout=poll_interval)
            for wid, st in list(workers.items()):
                if st["done"]:
                    continue
                for msg in received(st["conn"]):
                    if msg is None:
                        handle_failure(wid, "process died without reporting")
                        break
                    kind, payload = msg
                    if kind == "sample":
                        st["slots"].release()
                        sample = _sample_from_shm(payload)
                        yielded[sample["shard_name"]].add(sample["filename"])
                        yield sample
                    elif kind == "shard_done":
                        st["completed"].add(payload[1])
                    elif kind == "error":
                        handle_failure(wid, payload[1])
                    else:  # done
                        st["done"] = True
                    if st["done"]:
                        break
    finally:
        for st in workers.values():
            p = st["proc"]
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
            # unlink the segments of samples never delivered (the consumer
            # left early); those of killed workers are reclaimed by
            # multiprocessing's resource tracker when the process ends
            for msg in received(st["conn"]):
                if msg is not None and msg[0] == "sample":
                    unlink(msg[1])
            st["conn"].close()


def empty_batch_like(batch: Dict) -> Dict:
    """An all-masked batch with the same array shapes (a lock-step no-op)."""
    out = {}
    # a snapshot: consumers stage extra keys into (copies of) loader batches
    # on other threads
    for key, val in list(batch.items()):
        if isinstance(val, np.ndarray):
            out[key] = np.zeros_like(val)
        elif isinstance(val, list):
            out[key] = ["" if isinstance(v, str) else 0 for v in val]
        else:
            out[key] = val
    return out


def empty_batch(batch_size: int, num_frames: int = 32, size: int = 256,
                audio_len: int = 160000) -> Dict:
    """An all-masked batch built from config shapes (for ranks whose local
    loader yields nothing but that must still step with the others)."""
    return {
        "filename": [""] * batch_size,
        "shard_name": [""] * batch_size,
        "shard_size": [0] * batch_size,
        "batch_mask": np.zeros(batch_size, bool),
        "frames": np.zeros((batch_size, num_frames, size, size, 3), np.uint8),
        "audio": np.zeros((batch_size, audio_len), np.float32),
        "valid_samples": np.full((batch_size,), audio_len, np.int32),
    }


def pad_to_length(batches: Iterable[Dict], num_batches: int,
                  template: Optional[Dict] = None) -> Iterator[Dict]:
    """Yield ``batches``, then all-masked padding up to ``num_batches``.

    The lock-step half of the reference's ``ResizedDataset`` +
    ``get_length`` contract (``mps/distributed.py:444-461``): ranks whose
    shards run short step through masked no-op batches, so every rank runs
    the same number of steps.
    """
    n = 0
    last = None
    for b in batches:
        last = b
        n += 1
        yield b
    pad = empty_batch_like(last) if last is not None else template
    while n < num_batches:
        if pad is None:
            raise ValueError(
                "pad_to_length needs a template batch when the local loader "
                "is empty"
            )
        yield pad
        n += 1


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
    pad_to_batches: Optional[int] = None,
    pad_template: Optional[Dict] = None,
    empty: Callable = np.empty,
) -> Iterable[Dict]:
    """Batched clip loader.

    ``num_workers`` > 0 decodes the shards in that many spawned worker
    processes (at most one per shard; shards split round-robin as in the
    reference's ``worker_urls``), which stream samples through queues of
    at most ``buffer_samples`` clips in all. ``decoder`` and ``prepare`` must then
    pickle: a decoder instance or module-level function, a
    ``functools.partial`` of ``prepare_clip``. With 0 workers or a single
    shard, decoding runs in-process. Either way a background thread keeps
    ``prefetch`` batches ahead. ``pad_to_batches`` pads the batches with
    all-masked ones up to that count (``pad_to_length``; ``pad_template``
    when this process has no batch at all). ``empty(shape, dtype)``
    allocates each batch array that ``collate`` writes the samples into.
    """
    if num_workers > 0 and len(shard_paths) > 1:
        num_workers = min(num_workers, len(shard_paths))
        source = _pooled_stream(shard_paths, metas, skip_lists, decoder, prepare,
                                num_workers, buffer_samples)
    else:
        source = TarShardDataset(shard_paths, metas, skip_lists, decoder, prepare)
    batches = batched(source, batch_size, empty)
    if pad_to_batches is not None:
        batches = pad_to_length(batches, pad_to_batches, pad_template)
    if prefetch:
        return Prefetcher(batches, depth=prefetch)
    return batches
