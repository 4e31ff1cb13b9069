"""ctypes bindings for the native tar indexer (``native/tario.cc``).

A copy of ``acav100m_tpu/data/native_tar.py`` (the port imports nothing of
the JAX package), built by ``native_build`` into ``build/``. Member
iteration becomes one header walk plus offset ``pread``s, so the host's
cores go to decoding, not to Python tar parsing. Without a compiler the
callers fall back to Python ``tarfile``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

from .native_build import build_library

_lock = threading.Lock()
_lib = None
_load_failed = False


class _TarEntry(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("offset", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
    ]


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build_library("tario", timeout=120)
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.tario_index.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(_TarEntry)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tario_index.restype = ctypes.c_int
        lib.tario_free.argtypes = [ctypes.POINTER(_TarEntry), ctypes.c_uint64]
        lib.tario_free.restype = None
        lib.tario_read.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        lib.tario_read.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def index_tar(path) -> Optional[List[Tuple[str, int, int]]]:
    """[(member_name, data_offset, size)] via the native walk, or None."""
    lib = get_lib()
    if lib is None:
        return None
    entries = ctypes.POINTER(_TarEntry)()
    count = ctypes.c_uint64()
    rc = lib.tario_index(str(path).encode(), ctypes.byref(entries),
                         ctypes.byref(count))
    if rc != 0:
        return None
    try:
        return [
            (
                entries[i].name.decode("utf-8", errors="replace"),
                int(entries[i].offset),
                int(entries[i].size),
            )
            for i in range(count.value)
        ]
    finally:
        lib.tario_free(entries, count)


def read_member(path, offset: int, size: int) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(size)
    got = lib.tario_read(str(path).encode(), offset, size, buf)
    if got != size:
        return None
    return buf.raw
