"""Work of the non-local blocks of SLOWFAST_NLN_8x8_R50, from their shapes.

Five blocks on the slow pathway (T/4 frames): two at ``res3`` (1/8 of the
frame's side, dim 512, inner 256) and three at ``res4`` (1/16, dim 1024,
inner 512); keys max-pooled 1x2x2. The core of a block, ``dot_product``'s
``y = g (theta^T phi / Nk)^T`` over theta (Ci, Nq), phi and g (Ci, Nk), is
counted in the cheaper of its two orders, ``(g phi^T / Nk) theta``: 2 Ci^2 Nk
+ 2 Ci^2 Nq operations, against the published order's 4 Nq Nk Ci. Bytes:
theta, phi and g read once and y written once. ``per_clip`` is the FLOPs of a
clip through the plain reference (``reference/slowfast_nln.py``, counted by
``torch.utils.flop_counter`` as ``counts/model_flops.py`` counts SlowFast)
with each core counted in the cheaper order, plus VGGish's.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import model_flops
from benchmark.reference.slowfast_nln import NLN_LOCATION, SlowFastNlnTaps

# (stage's spatial reduction, inner channels) of each block, s2..s5
STAGES = ((4, 128), (8, 256), (16, 512), (32, 1024))


def blocks(num_frames: int, size: int) -> List[Tuple[int, int, int]]:
    """(Nq, Nk, Ci) of each non-local block of a clip."""
    t = num_frames // 4
    out = []
    for (red, ci), where in zip(STAGES, NLN_LOCATION):
        hw = size // red
        out += [(t * hw * hw, t * (hw // 2) ** 2, ci)] * len(where)
    return out


def core_flops(nq: int, nk: int, ci: int) -> float:
    return 2.0 * ci * ci * nk + 2.0 * ci * ci * nq


def published_core_flops(nq: int, nk: int, ci: int) -> float:
    return 4.0 * nq * nk * ci


def core_bytes(nq: int, nk: int, ci: int, itemsize: int) -> float:
    return float((2 * ci * nq + 2 * ci * nk) * itemsize)


def ideal_seconds(batch: int, num_frames: int, size: int, itemsize: int, peak_flops: float,
                  peak_bytes: float) -> float:
    """A batch's cores' least time on the card: each block at the larger of
    its two bounds."""
    return sum(max(batch * core_flops(*b) / peak_flops,
                   batch * core_bytes(*b, itemsize) / peak_bytes)
               for b in blocks(num_frames, size))


@functools.lru_cache(maxsize=None)
def slowfast_nln(num_frames: int, size: int) -> float:
    """A clip through the reference, each core in the cheaper order."""
    with torch.device("meta"):
        model = SlowFastNlnTaps()
        frames = torch.zeros((1, num_frames, size, size, 3), dtype=torch.uint8)
        with FlopCounterMode(display=False) as counter:
            model(frames)
    cores = blocks(num_frames, size)
    return (float(counter.get_total_flops()) - sum(published_core_flops(*b) for b in cores)
            + sum(core_flops(*b) for b in cores))


def per_clip(num_frames: int, size: int, audio_seconds: float) -> float:
    return slowfast_nln(num_frames, size) + model_flops.vggish(audio_seconds)
