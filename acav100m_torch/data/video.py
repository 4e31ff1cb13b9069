"""Clip decoding: pre-materialized npz clips.

The npz parts of ``acav100m_tpu/data/video.py``, copied (the port imports
nothing of the JAX package). A clip is an ``.npz`` with ``frames`` uint8
(T,H,W,3), ``audio`` float32 and ``sample_rate``. Post-decode logic matches
the reference (``feature_extraction/code/data/video.py``): uniform temporal
sampling to ``num_frames`` via ``linspace(0, T-1, n)``, skipping clips
shorter than ``duration/4``, mono mix, audio at 16 kHz padded to a static
length with ``valid_samples`` recorded. The mp4 decoders are not ported.
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np


def temporal_sampling(frames: np.ndarray, num_frames: int) -> np.ndarray:
    """Uniformly sample ``num_frames`` frames (reference video.py:53-57)."""
    t = frames.shape[0]
    indices = np.linspace(0, t - 1, num_frames).astype(np.int64)
    return frames[indices]


def to_mono(audio: np.ndarray) -> np.ndarray:
    """(S,) or (S, C)/(C, S) -> mono (S,)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        return audio
    if audio.ndim == 2:
        # channels on the smaller axis
        if audio.shape[0] < audio.shape[1]:
            return audio.mean(axis=0)
        return audio.mean(axis=1)
    raise ValueError(f"bad audio shape {audio.shape}")


def decode_npz(data: bytes) -> Optional[Dict]:
    """Pre-materialized clip: npz{frames, audio, sample_rate[, video_fps]};
    None for bytes that are not such a clip."""
    try:
        with np.load(io.BytesIO(data)) as z:
            out = {
                "frames": np.asarray(z["frames"], dtype=np.uint8),
                "audio": to_mono(np.asarray(z["audio"], dtype=np.float32)),
                "sample_rate": int(z["sample_rate"]),
            }
            if "video_fps" in z:
                out["video_fps"] = float(z["video_fps"])
            else:
                out["video_fps"] = float(out["frames"].shape[0]) / 10.0
            return out
    except Exception:
        return None


def get_decoder(name: str = "npz", **kwargs):
    if name == "npz":
        return decode_npz
    raise NotImplementedError(f"decoder {name!r} is not ported; use 'npz'")


def prepare_clip(
    decoded: Optional[Dict],
    num_frames: int = 32,
    duration: float = 10.0,
    skip_shorter_seconds: Optional[float] = 2.5,
    audio_samples: Optional[int] = None,
    target_sample_rate: int = 16000,
) -> Optional[Dict]:
    """Decoded clip -> static-shape arrays: ``num_frames`` uniformly sampled
    frames; None for clips shorter than ``skip_shorter_seconds``; audio
    resampled to 16 kHz (scipy polyphase) and zero-padded or cut to
    ``audio_samples`` with ``valid_samples`` recorded."""
    if decoded is None or decoded["frames"].shape[0] == 0:
        return None
    frames = decoded["frames"]
    fps = decoded.get("video_fps") or frames.shape[0] / duration
    if skip_shorter_seconds is not None and frames.shape[0] / fps < skip_shorter_seconds:
        return None
    frames = temporal_sampling(frames, num_frames)

    audio = to_mono(decoded["audio"])
    sr = decoded["sample_rate"]
    if audio.shape[0] == 0:
        return None
    if sr != target_sample_rate:
        import math

        from scipy.signal import resample_poly

        g = math.gcd(target_sample_rate, sr)
        audio = resample_poly(
            audio.astype(np.float64), target_sample_rate // g, sr // g
        ).astype(np.float32)
    if audio_samples is None:
        audio_samples = int(round(duration * target_sample_rate))
    valid = min(audio.shape[0], audio_samples)
    buf = np.zeros(audio_samples, dtype=np.float32)
    buf[:valid] = audio[:valid]
    return {
        "frames": frames,
        "audio": buf,
        "valid_samples": valid,
        "sample_rate": target_sample_rate,
    }
