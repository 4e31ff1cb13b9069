"""Decoders for the port's pooled-loader tests. They live in a module of
their own that imports only the port, so a spawned decode worker that
unpickles one imports neither JAX nor the test files."""

import os
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
