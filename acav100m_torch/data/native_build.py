"""Build the host libraries of ``native/`` for the port.

``native/tario.cc`` (tar header walk) and ``native/avio.cc`` (FFmpeg media
IO) belong to neither package. The port compiles each with g++ at first use
into ``build/lib<name>-<hash>.so`` at the root of the checkout, where the
hash covers the source and the flags, so an edited source is rebuilt and
never confused with an old library. The library is written to a temporary
file and moved into place with ``os.replace``: processes that build at the
same moment never load a half-written file, and the JAX package's own
``native/lib*.so`` are never touched.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE = ROOT / "native"
BUILD_DIR = ROOT / "build"
CFLAGS = ("-O2", "-shared", "-fPIC")


def build_library(name: str, libs: Sequence[str] = (),
                  timeout: float = 300) -> Optional[Path]:
    """Path of the built ``native/<name>.cc``, compiling it if needed; None
    when there is no compiler or the source does not compile (for avio:
    FFmpeg's headers or libraries are missing)."""
    src = NATIVE / f"{name}.cc"
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None or not src.is_file():
        return None
    flags = [*CFLAGS, *libs]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest[:12]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run([gxx, *CFLAGS, "-o", str(tmp), str(src), *libs],
                              capture_output=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return None
    if proc.returncode != 0 or not tmp.is_file():
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib
