"""Evaluation-suite data pipeline, the counterpart of
``acav100m_tpu/evaluation/data.py``. Everything but the log-mel is numpy
and a copy (the port imports nothing of the JAX package); every
``RandomState`` draw happens in the JAX package's order, so one seed gives
the same batches in both packages.

Rebuild of the reference's pretrain/downstream datasets
(``evaluation/code/data/{acav,contrast,transform,ucf101,esc50,
kinetics_sounds}.py``):

* pretrain examples from curated tar shards: decode full clip -> random
  ``num_frames x sampling_rate`` visual window (crop+flip) + aligned 2 s
  audio window -> log-mel 80 x 128 -> SpecAugment-style time/freq masks;
* downstream classification examples: uniform clips + labels; UCF101
  (3 splits), ESC-50 (5 folds, audio-only), Kinetics-Sounds (audio-visual)
  download scripts don't run in a no-egress image, so loaders accept
  pre-materialized npz clip directories with a ``labels.json`` — same
  example format either way;
* test-time ensembling enumerates NUM_ENSEMBLE_VIEWS temporal clips whose
  scores the meter sums per video (``utils/meters.py:522-689``).

The log-mel frontend is the port's GEMM-native ``ops.melspec``, run on
the host CPU, with the evaluation parameterization (80 mel bins over 2 s
of 16 kHz audio -> 128 frames after the 15.625 ms hop).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import melspec

AUDIO_FREQUENCY = 80  # mel bins (config.py:322)
AUDIO_TIME = 128  # spectrogram frames (config.py:325)
CLIP_DURATION = 2.0  # seconds of audio per example (config.py:315)
SAMPLE_RATE = 16000
FREQ_MASK_RATE = 0.05
TIME_MASK_RATE = 0.05


def audio_logmel_80x128(audio_2s: np.ndarray) -> np.ndarray:
    """2 s of 16 kHz audio -> (80, 128) log-mel.

    Window/hop chosen so 2 s -> exactly 128 frames: hop 15.625 ms
    (256 samples), window 32 ms. Returned layout (freq, time) to match the
    reference's ``channel x frequency x time`` (transposed to NHWC by the
    batcher).
    """
    lm = melspec.log_mel_spectrogram(
        torch.from_numpy(np.ascontiguousarray(audio_2s, np.float32)),
        audio_sample_rate=SAMPLE_RATE,
        log_offset=0.01,
        window_length_secs=0.032,
        hop_length_secs=0.015625,
        num_mel_bins=AUDIO_FREQUENCY,
        lower_edge_hertz=20.0,
        upper_edge_hertz=7600.0,
    )  # (frames, 80)
    lm = lm.numpy()[:AUDIO_TIME]
    if lm.shape[0] < AUDIO_TIME:
        lm = np.pad(lm, ((0, AUDIO_TIME - lm.shape[0]), (0, 0)))
    return lm.T  # (80, 128)


def spec_augment(lm: np.ndarray, rng: np.random.RandomState,
                 freq_rate: float = FREQ_MASK_RATE,
                 time_rate: float = TIME_MASK_RATE) -> np.ndarray:
    """SpecAugment-style one-mask-per-axis (data/transform.py:195-257)."""
    lm = lm.copy()
    f, t = lm.shape
    fm = int(round(f * freq_rate))
    tm = int(round(t * time_rate))
    if fm > 0:
        f0 = rng.randint(0, f - fm + 1)
        lm[f0 : f0 + fm] = 0.0
    if tm > 0:
        t0 = rng.randint(0, t - tm + 1)
        lm[:, t0 : t0 + tm] = 0.0
    return lm


def uniform_crop_offsets(h: int, w: int, size: int, spatial_idx: int
                         ) -> Tuple[int, int]:
    """Test-time uniform crop positions (transform.py:89-127): 0/1/2 =
    left/center/right when width > height, top/center/bottom otherwise."""
    assert spatial_idx in (0, 1, 2)
    y = int(np.ceil(max(h - size, 0) / 2))
    x = int(np.ceil(max(w - size, 0) / 2))
    if h > w:
        if spatial_idx == 0:
            y = 0
        elif spatial_idx == 2:
            y = max(h - size, 0)
    else:
        if spatial_idx == 0:
            x = 0
        elif spatial_idx == 2:
            x = max(w - size, 0)
    return y, x


def random_visual_window(frames: np.ndarray, num_frames: int, crop: int,
                         rng: np.random.RandomState,
                         train: bool = True,
                         spatial_idx: Optional[int] = None
                         ) -> Tuple[np.ndarray, int]:
    """Random contiguous frame window + spatial crop + hflip.

    Test mode (``train=False``): ``spatial_idx`` selects the uniform crop
    position (None -> center, matching NUM_SPATIAL_CROPS=1).
    Returns (clip (num_frames, crop, crop, 3), start_frame).
    """
    t, h, w, _ = frames.shape
    start = rng.randint(0, max(t - num_frames, 0) + 1) if train else max(
        (t - num_frames) // 2, 0
    )
    idx = np.clip(np.arange(start, start + num_frames), 0, t - 1)
    clip = frames[idx]
    if train:
        y = rng.randint(0, max(h - crop, 0) + 1)
        x = rng.randint(0, max(w - crop, 0) + 1)
    else:
        y, x = uniform_crop_offsets(h, w, crop, 1 if spatial_idx is None
                                    else spatial_idx)
    clip = clip[:, y : y + crop, x : x + crop]
    if clip.shape[1] < crop or clip.shape[2] < crop:
        clip = np.pad(
            clip,
            ((0, 0), (0, crop - clip.shape[1]), (0, crop - clip.shape[2]), (0, 0)),
        )
    if train and rng.rand() < 0.5:
        clip = clip[:, :, ::-1]
    return clip, int(idx[0])


def make_pretrain_example(
    decoded: Dict,
    rng: np.random.RandomState,
    num_frames: int = 8,
    crop: int = 112,
    train: bool = True,
    spatial_idx: Optional[int] = None,
) -> Optional[Dict]:
    """Decoded clip -> {visual (T,H,W,3) uint8, audio_logmel (80,128)}.

    Audio window aligned with the visual window (data/contrast.py:25-179).
    ``spatial_idx`` (test only): uniform crop position for
    NUM_SPATIAL_CROPS ensembling.
    """
    frames = decoded["frames"]
    audio = decoded["audio"]
    sr = decoded["sample_rate"]
    fps = decoded.get("video_fps") or 30.0
    if frames.shape[0] == 0 or audio.shape[0] < int(0.5 * sr):
        return None
    clip, start_frame = random_visual_window(frames, num_frames, crop, rng,
                                             train, spatial_idx=spatial_idx)
    # aligned audio window centered on the visual window
    center_sec = (start_frame + num_frames / 2) / fps
    a0 = int(max(center_sec - CLIP_DURATION / 2, 0) * sr)
    need = int(CLIP_DURATION * sr)
    window = audio[a0 : a0 + need]
    if window.shape[0] < need:
        window = np.pad(window, (0, need - window.shape[0]))
    lm = audio_logmel_80x128(window.astype(np.float32))
    if train:
        lm = spec_augment(lm, rng)
    return {"visual": np.ascontiguousarray(clip), "audio_logmel": lm}


def collate_pretrain(examples: List[Dict]) -> Dict[str, np.ndarray]:
    """-> {visual (B,T,H,W,3) uint8, audio (B,80,128,1) f32}."""
    visual = np.stack([e["visual"] for e in examples])
    audio = np.stack([e["audio_logmel"] for e in examples])[..., None]
    return {"visual": visual, "audio": audio.astype(np.float32)}


def pretrain_batches(
    shard_paths: Sequence,
    metas: Dict,
    batch_size: int,
    rng: np.random.RandomState,
    num_frames: int = 8,
    crop: int = 112,
    decoder=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream pretrain batches from curated tar shards."""
    from ..data.tar_dataset import TarShardDataset
    from ..data.video import decode_npz

    ds = TarShardDataset(
        shard_paths, metas,
        decoder=decoder or decode_npz,
        prepare=lambda d: d,  # raw decode; windowing happens here
    )
    buf: List[Dict] = []
    for sample in ds:
        ex = make_pretrain_example(sample, rng, num_frames, crop)
        if ex is None:
            continue
        buf.append(ex)
        if len(buf) == batch_size:
            yield collate_pretrain(buf)
            buf = []


# -- downstream classification datasets ------------------------------------------

class ClipClassificationDataset:
    """Directory of npz clips + labels.json -> classification examples.

    labels.json: {"classes": [...], "items": [{"file": ..., "label": int,
    ...membership...}]}. Item membership, per protocol:

    * flat:          {"split": "train"|"test"} (default);
    * UCF101-style 3 official splits (``data/ucf101.py:16-109``):
      {"splits": {"1": "train"|"test", "2": ..., "3": ...}} selected via
      ``split_id``;
    * ESC-50-style 5-fold CV (``data/esc50.py:17-188``): {"fold": 1..5}
      selected via ``fold`` — the given fold is the test set, the rest
      train.

    This is the pre-materialized stand-in for UCF101/ESC-50/
    Kinetics-Sounds (whose fetch scripts need egress); the example format,
    split/fold protocol, and NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS test
    ensembling match the reference loaders.
    """

    def __init__(self, root, split: str = "train",
                 num_ensemble_views: int = 2,
                 num_spatial_crops: int = 1,
                 split_id: Optional[int] = None,
                 fold: Optional[int] = None):
        self.root = Path(root)
        spec = json.loads((self.root / "labels.json").read_text())
        self.classes = spec["classes"]
        self.items = [
            it for it in spec["items"]
            if self._membership(it, split_id, fold) == split
        ]
        self.split = split
        self.num_ensemble_views = num_ensemble_views
        self.num_spatial_crops = num_spatial_crops

    @staticmethod
    def _membership(item: Dict, split_id: Optional[int],
                    fold: Optional[int]) -> str:
        if fold is not None:
            return "test" if int(item["fold"]) == int(fold) else "train"
        if split_id is not None:
            return item["splits"][str(split_id)]
        return item.get("split", "train")

    def __len__(self):
        return len(self.items)

    def load(self, i: int) -> Dict:
        item = self.items[i]
        with np.load(self.root / item["file"]) as z:
            decoded = {
                "frames": np.asarray(z["frames"], np.uint8),
                "audio": np.asarray(z["audio"], np.float32),
                "sample_rate": int(z["sample_rate"]),
                "video_fps": float(z["video_fps"]) if "video_fps" in z else 30.0,
            }
        return {"decoded": decoded, "label": int(item["label"]), "video_index": i}

    def examples(self, rng: np.random.RandomState, num_frames=8, crop=112
                 ) -> Iterator[Dict]:
        """Train: one random view per item. Test: NUM_ENSEMBLE_VIEWS uniform
        temporal views x NUM_SPATIAL_CROPS uniform crops per item — the
        reference's spatial_temporal_idx enumeration (``data/ucf101.py:
        148-166``); meters sum all view scores per video_index."""
        train = self.split == "train"
        for i in range(len(self.items)):
            row = self.load(i)
            if train:
                ex = make_pretrain_example(row["decoded"], rng, num_frames,
                                           crop, train=True)
                if ex is not None:
                    yield {**ex, "label": row["label"], "video_index": i}
            else:
                t = row["decoded"]["frames"].shape[0]
                for v in range(self.num_ensemble_views):
                    sub = dict(row["decoded"])
                    start = int(v * max(t - num_frames, 0) /
                                max(self.num_ensemble_views - 1, 1))
                    sub["frames"] = sub["frames"][start:]
                    for s in range(self.num_spatial_crops):
                        # 1 crop -> center; 3 crops -> left/center/right
                        spatial_idx = 1 if self.num_spatial_crops == 1 else s
                        ex = make_pretrain_example(
                            sub, rng, num_frames, crop, train=False,
                            spatial_idx=spatial_idx,
                        )
                        if ex is not None:
                            yield {**ex, "label": row["label"],
                                   "video_index": i}
