"""Device-time profile of one extract batch on one GPU.

    python -m acav100m_torch.profiling [--dtype bfloat16] [--by-shape]

Runs one warm extract batch of 4 synthetic clips through both full-width
models (32 frames of 256x256, seeded weights, in float32 with PyTorch's
default TF32 for cuDNN convolutions, or in bfloat16 as
``computation.dtype=bfloat16`` runs them) under ``torch.profiler`` (CUDA
activity). It
prints the device time by kernel name, the summed device time and the wall
time, so the device's busy share is their ratio. With ``--by-shape`` it
also records input shapes and prints the convolutions' device time by
input and weight shape (recording shapes adds host time to the wall time).
The kernels' own times at the main paths' shapes come from
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .models import init_weights
from .models.slowfast import LayerSlowFast
from .models.vggish import LayerVggish


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def graphed(fn):
    """``fn`` captured once in a CUDA graph; returns its replay. Timing the
    replay leaves out the host's work around each launch (allocations,
    argument packing), which a short kernel can take less time than."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` back-to-back calls, each between two CUDA events.
    Nothing synchronizes inside the loop, so the host's launch work overlaps
    the queued device work and a call's time is the device's, as long as
    the host issues a call faster than the device runs it."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def time_cold_ms(fn, sets, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """``time_ms`` of ``fn(*args)`` with the calls rotating over ``sets`` of
    arguments, so that inputs larger than the L2 in all come from device
    memory, as they would for a caller that has not just touched them.
    With ``graph``, each set's call is a CUDA graph replay (``graphed``)."""
    calls = [functools.partial(fn, *args) for args in sets]
    if graph:
        calls = [graphed(c) for c in calls]
    rotation = itertools.cycle(calls)
    return time_ms(lambda: next(rotation)(), iters, warmup)


def _device_us(evt, names=("self_device_time_total", "self_cuda_time_total")) -> float:
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _total_device_us(evt) -> float:
    """Device time of an operator row, the kernels it launched included."""
    return _device_us(evt, ("device_time_total", "cuda_time_total"))


def _device_events(prof):
    """The profile's device rows (kernels and copies); the operator rows
    (aten::...) repeat their kernels' time."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA and _device_us(e) > 0]
    if not events:
        events = [e for e in prof.key_averages()
                  if _device_us(e) > 0 and not e.key.startswith("aten::")]
    return events


def device_busy(fn):
    """``fn()`` once under ``torch.profiler`` (device activity only) ->
    (wall seconds, seconds of kernels, seconds of copies). Host threads
    and other processes are not traced, so tracing costs the host little."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    copies = sum(_device_us(e) for e in events if e.key.startswith("Memcpy"))
    kernels = sum(_device_us(e) for e in events) - copies
    return wall, kernels / 1e6, copies / 1e6


def run(label: str, fn, iters: int = 3, top: int = 16, by_shape: bool = False) -> None:
    fn()  # warm: builds kernels, picks cuDNN algorithms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_shape) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    events = _device_events(prof)
    events.sort(key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in events) / iters
    print(f"== {label}: wall {wall_us:.1f} us/iter, device busy {busy_us:.1f} us/iter "
          f"({100 * busy_us / wall_us:.1f}%)")
    for e in events[:top]:
        print(f"   {_device_us(e) / iters:10.1f} us  x{e.count // iters:<4d} {e.key[:90]}")
    if by_shape:
        convs = [e for e in prof.key_averages(group_by_input_shape=True)
                 if e.key == "aten::convolution"]
        convs.sort(key=_total_device_us, reverse=True)
        print("   convolutions by (input, weight) shape:")
        for e in convs[:top]:
            print(f"   {_total_device_us(e) / iters:10.1f} us  x{e.count // iters:<4d} "
                  f"{e.input_shapes[:2]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="device time of one warm extract batch")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                    help="the models' compute dtype (computation.dtype)")
    ap.add_argument("--by-shape", action="store_true",
                    help="also print the convolutions' device time by shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    print(card())
    with torch.inference_mode():
        sf, vg = LayerSlowFast(dtype=args.dtype), LayerVggish(dtype=args.dtype)
        init_weights(sf, gen)
        init_weights(vg, gen)
        sf.to(dev).eval()
        vg.to(dev).eval()
        frames = torch.randint(0, 255, (4, 32, 256, 256, 3), generator=gen,
                               dtype=torch.uint8).to(dev)
        audio = (0.1 * torch.randn((4, 160000), generator=gen)).to(dev)
        valid = torch.full((4,), 160000, device=dev)
        run(f"extract batch (4 clips, SlowFast + VGGish, {args.dtype})",
            lambda: (sf(frames), vg(audio, valid)), by_shape=args.by_shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
