"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``acav100m_torch/csrc/<name>.cu`` exposes a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/<name>-<hash>.so`` at the root of the checkout
and loaded with ``ctypes``. The hash covers the source and the flags, so an
edited source is rebuilt and never confused with an old library. Nothing
here runs at import time: the CPU tests import every module on a machine
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

from .. import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc process; returns (popen or None, tmp path, target)."""
    src, lib = _target(name)
    if lib.is_file():
        return None, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, lib


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named kernels, one ``nvcc`` per source, all started
    together, in one ``span.kernels.build`` (``names``: those it compiled).
    Returns {name: library path}; raises on any failure."""
    with tracing.span("span.kernels.build") as span:
        started = {n: _start(n) for n in names}
        if span is not None:
            span.attrs["names"] = [n for n, (proc, _, _) in started.items() if proc is not None]
        out: Dict[str, Path] = {}
        errors = []
        for name, (proc, tmp, lib) in started.items():
            if proc is not None:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
                    continue
                os.replace(tmp, lib)
            out[name] = lib
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
            tracing.count("kernels.loads")
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
