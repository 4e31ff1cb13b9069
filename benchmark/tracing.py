"""The traced window's device timeline, read from ``torch.profiler``.

The device's busy time is the union of its kernel, copy and set intervals
(a copy on a side stream that overlaps a kernel counts once), not their
sum. Idle gaps are the stretches between those intervals; their time is
named by the benchmark's own spans (around calls into the program's
layers) open during it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def _device_type_cuda(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


def union_length(intervals: Sequence[Tuple[int, int]]) -> int:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Timeline:
    """Device and host events of one traced window (times in ns)."""

    def __init__(self, prof, window_s: float):
        events = prof.profiler.kineto_results.events()
        self.device: List[Tuple[str, int, int]] = []
        host: List[Tuple[int, int, str]] = []
        for e in events:
            start, dur = int(e.start_ns()), int(e.duration_ns())
            if _device_type_cuda(e):
                # a span's shadow on the device timeline covers kernels
                # that have rows of their own
                if dur > 0 and not e.is_user_annotation():
                    self.device.append((e.name(), start, dur))
            elif dur > 0:
                host.append((start, start + dur, e.name()))
        self.host = sorted(host)
        self.window_s = window_s
        self.busy_s = union_length([(s, s + d) for _, s, d in self.device]) / 1e9

    def kernels(self, pattern: Optional[str] = None) -> List[Tuple[str, int, int]]:
        """Device kernels (not copies or sets), those whose name holds
        ``pattern`` if given."""
        out = [ev for ev in self.device
               if not ev[0].startswith(("Memcpy", "Memset"))]
        if pattern is not None:
            out = [ev for ev in out if pattern in ev[0]]
        return out

    def copies(self, kind: str) -> List[Tuple[str, int, int]]:
        """Copies whose name holds ``kind`` (``HtoD``, ``DtoH``, ...)."""
        return [ev for ev in self.device if ev[0].startswith("Memcpy") and kind in ev[0]]

    @staticmethod
    def seconds(events) -> float:
        return sum(d for _, _, d in events) / 1e9

    def idle_pct(self) -> Optional[float]:
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device's ten longest operations by total time, and the idle
        time of the window by the benchmark's span open during it (a gap
        that two spans overlap counts for both; ``no span open`` is the
        rest; gaps under 20 us, launch latency between queued kernels, are
        one entry)."""
        by_kernel: Dict[str, int] = defaultdict(int)
        for name, _, dur in self.device:
            by_kernel[name[:160]] += dur
        device_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
        busy = merged([(s, s + d) for _, s, d in self.device])
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
        short = [g for g in gaps if g[1] - g[0] < 20_000]
        long = [g for g in gaps if g[1] - g[0] >= 20_000]
        spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for s, e, name in self.host:
            if name.startswith("span."):
                spans[name].append((s, e))
        idle = {name[:160]: overlap(long, merged(iv)) for name, iv in spans.items()}
        covered = overlap(long, merged([iv for ivs in spans.values() for iv in ivs]))
        idle["no span open"] = sum(e - s for s, e in long) - covered
        idle["gaps under 20 us"] = sum(e - s for s, e in short)
        ranked = sorted(((k, v) for k, v in idle.items() if v > 0), key=lambda kv: -kv[1])
        return {"device_ops": [[name, ns / 1e9] for name, ns in device_ops],
                "idle_gaps": [[name, ns / 1e9] for name, ns in ranked[:top]]}


def overlap(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """Total length common to two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def install_spans(points) -> "callable":
    """Wrap each ``(object, attribute, label)`` callable in a profiler span
    named ``label``, so that the traced window's idle gaps can be named by
    the benchmark's own spans around the calls into the program's layers;
    returns the function that takes the wrappers off."""
    import functools

    from torch.profiler import record_function

    undo = []
    for obj, attr, label in points:
        orig = getattr(obj, attr)

        def wrapped(*args, _orig=orig, _label=label, **kwargs):
            with record_function(_label):
                return _orig(*args, **kwargs)

        functools.update_wrapper(wrapped, orig)
        setattr(obj, attr, wrapped)
        undo.append((obj, attr, orig))

    def remove():
        for obj, attr, orig in reversed(undo):
            setattr(obj, attr, orig)

    return remove
