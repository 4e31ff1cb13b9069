"""FLOPs of one clip through both models, counted once over the plain
reference on the meta device with ``torch.utils.flop_counter`` (the
convolutions and dense layers; batch norm, pooling and the log-mel front
end are not counted). For scale: PySlowFast publishes SLOWFAST_8x8_R50 at
65.71 GFLOPs (multiply-adds) a view of 32 frames at 256 short side.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.slowfast import SlowFastTaps
from benchmark.reference.vggish import EXAMPLE, MELS, VggishTaps


@functools.lru_cache(maxsize=None)
def slowfast(num_frames: int, size: int) -> float:
    with torch.device("meta"):
        model = SlowFastTaps()
        frames = torch.zeros((1, num_frames, size, size, 3), dtype=torch.uint8)
        with FlopCounterMode(display=False) as counter:
            model(frames)
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def vggish(audio_seconds: float) -> float:
    examples = 1 + (int(round(audio_seconds * 100)) - 2 - EXAMPLE) // EXAMPLE
    with torch.device("meta"):
        model = VggishTaps()
        x = torch.zeros((examples, 1, EXAMPLE, MELS))
        with FlopCounterMode(display=False) as counter:
            h = model.features(x)
            model.embeddings(h.permute(0, 2, 3, 1).reshape(examples, -1))
    return float(counter.get_total_flops())


def per_clip(num_frames: int, size: int, audio_seconds: float) -> float:
    return slowfast(num_frames, size) + vggish(audio_seconds)
