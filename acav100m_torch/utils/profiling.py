"""Lightweight profiling for train loops: scalar meters, iteration timers,
json stat lines and a device trace.

A copy of ``acav100m_tpu/utils/profiling.py`` (the port imports nothing of
the JAX package): ``ScalarMeter`` windows (reference
``evaluation/code/utils/meters.py``), ``IterTimer``, ``Meters``,
``log_json_stats`` lines (reference ``utils/logging.py:56-68``),
``get_open_fds`` and a ``TensorBoardWriter`` that is a no-op without
tensorboard. ``device_trace`` writes a ``torch.profiler`` trace where the
JAX package starts a ``jax.profiler`` one. The kernel-timing helpers of the
port's own card runs are in ``acav100m_torch.profiling``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Deque, Dict, Optional


class ScalarMeter:
    """Windowed scalar statistics (reference meters.py:15-60)."""

    def __init__(self, window_size: int = 10):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    def get_win_median(self) -> float:
        vals = sorted(self.deque)
        return vals[len(vals) // 2] if vals else 0.0

    def get_win_avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class IterTimer:
    """Per-iteration wall-clock with running mean."""

    def __init__(self, window_size: int = 50):
        self.meter = ScalarMeter(window_size)
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.meter.add_value(dt)
        return dt

    @property
    def mean(self) -> float:
        return self.meter.get_global_avg()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace (host, and the card where there is one)
    written to ``log_dir/trace.json`` when a log dir is given, else a
    no-op."""
    if log_dir is None:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class TensorBoardWriter:
    """Master-only scalar writer (reference utils/logging.py:12-68 +
    meters' TB writer). Gated on tensorboard availability; no-op when the
    package or the log dir is absent."""

    def __init__(self, log_dir=None, enabled: bool = True):
        self.writer = None
        if not enabled or log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self.writer = SummaryWriter(str(log_dir))
        except Exception:
            try:
                import tensorflow as tf  # type: ignore

                self._tf = tf
                self.writer = tf.summary.create_file_writer(str(log_dir))
            except Exception:
                self.writer = None

    def add_scalars(self, scalars: Dict[str, float], step: int):
        if self.writer is None:
            return
        if hasattr(self.writer, "add_scalar"):  # torch SummaryWriter
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, step)
        else:  # tf writer
            with self.writer.as_default():
                for k, v in scalars.items():
                    self._tf.summary.scalar(k, v, step=step)

    def close(self):
        if self.writer is not None and hasattr(self.writer, "close"):
            self.writer.close()


class Meters:
    """A named bag of scalar meters for train loops."""

    def __init__(self, window_size: int = 10):
        self.window_size = window_size
        self.meters: Dict[str, ScalarMeter] = {}

    def add(self, **values: float):
        for name, value in values.items():
            if name not in self.meters:
                self.meters[name] = ScalarMeter(self.window_size)
            self.meters[name].add_value(value)

    def snapshot(self) -> Dict[str, float]:
        return {k: m.get_win_avg() for k, m in self.meters.items()}

    def medians(self) -> Dict[str, float]:
        return {k: m.get_win_median() for k, m in self.meters.items()}

    def global_avgs(self) -> Dict[str, float]:
        return {k: m.get_global_avg() for k, m in self.meters.items()}


def get_open_fds() -> int:
    """Open file descriptors of this process (leak hunting during long
    extraction runs — reference ``feature_extraction/code/debug.py:1-17``,
    which shelled out to lsof; /proc is cheaper and dependency-free)."""
    import os

    try:
        return len(os.listdir(f"/proc/{os.getpid()}/fd"))
    except OSError:  # non-procfs platform
        return -1


def log_json_stats(stats: Dict, out_path=None, echo: bool = False) -> str:
    """One json stat line per event (reference ``utils/logging.py:56-68``:
    ``json_stats: {...}``). Appends to ``out_path`` (jsonl) when given."""
    import json

    line = json.dumps(stats, sort_keys=True, default=float)
    if echo:
        print(f"json_stats: {line}")
    if out_path is not None:
        from pathlib import Path

        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")
    return line
