"""Decoders for the port's pooled-loader tests. They live in a module of
their own that imports only the port, so a spawned decode worker that
unpickles one imports neither JAX nor the test files."""

import gc
import multiprocessing.connection
import multiprocessing.queues
import os
import struct
from pathlib import Path

from acav100m_torch.data.video import decode_npz

_decoded = 0


def crash_once_decoder(data, marker_path, crash_after=3):
    """decode_npz that hard-kills its worker process (``os._exit``: no
    exception, no queue message) on its ``crash_after``-th decode, once
    across all processes (a marker file records that it happened)."""
    global _decoded
    _decoded += 1
    marker = Path(marker_path)
    if _decoded >= crash_after and not marker.exists():
        marker.touch()
        os._exit(1)
    return decode_npz(data)


def die_holding_queue_lock(data, marker_path, crash_after=3):
    """decode_npz that, on its ``crash_after``-th decode (once across all
    processes), dies in the two ways a killed writer can leave its channel:
    it takes the write lock of every queue in its worker (the lock then
    stays taken for good, as when a worker is killed while a queue's feeder
    thread is writing), and it writes the first bytes of a message to every
    pipe it writes to (the message then stays cut short). Then it
    hard-kills the worker."""
    global _decoded
    _decoded += 1
    marker = Path(marker_path)
    if _decoded >= crash_after and not marker.exists():
        marker.touch()
        for obj in gc.get_objects():
            if isinstance(obj, multiprocessing.queues.Queue):
                obj._wlock.acquire()
            elif isinstance(obj, multiprocessing.connection.Connection) and obj.writable:
                # a message's length header promising 4096 bytes, then one
                os.write(obj.fileno(), struct.pack("!i", 4096) + b"\x80")
        os._exit(1)
    return decode_npz(data)
