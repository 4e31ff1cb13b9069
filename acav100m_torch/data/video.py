"""Clip decoding backends.

A copy of ``acav100m_tpu/data/video.py`` (the port imports nothing of the
JAX package). Every backend maps a clip's bytes to the same dict
(``frames`` uint8 (T,H,W,3), ``audio`` float32, ``sample_rate``,
``video_fps``) or None:

* ``decode_npz``: pre-materialized ``.npz`` clips;
* ``NativeAvDecoder``: mp4 bytes through FFmpeg's libraries
  (``native_av``), video and audio, in memory;
* ``FfmpegCliDecoder``: the ffmpeg binary, where one exists;
* ``OpenCVVideoDecoder``: OpenCV's bundled libavcodec, video only.

mp4 frames come out short-side scaled to ``size`` and center-cropped, so
batches have one static shape. Post-decode logic matches the reference
(``feature_extraction/code/data/video.py``): uniform temporal sampling to
``num_frames`` via ``linspace(0, T-1, n)``, skipping clips shorter than
``duration/4``, mono mix, audio at 16 kHz padded to a static length with
``valid_samples`` recorded.
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
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


class FfmpegCliDecoder:
    """Decode mp4 bytes with the ffmpeg binary (when present): short side
    scaled to ``size`` and center-cropped, mono audio at ``sample_rate``."""

    def __init__(self, size: int = 256, sample_rate: int = 16000):
        self.size = size
        self.sample_rate = sample_rate
        self.ffmpeg = shutil.which("ffmpeg")
        self.ffprobe = shutil.which("ffprobe")

    @property
    def available(self) -> bool:
        return self.ffmpeg is not None

    def __call__(self, data: bytes) -> Optional[Dict]:
        if not self.available:
            raise RuntimeError("ffmpeg binary not found")
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(data)
            f.flush()
            return self.decode_path(f.name)

    def _probe(self, path) -> Dict:
        out = subprocess.run(
            [self.ffprobe, "-v", "error", "-print_format", "json",
             "-show_streams", str(path)],
            capture_output=True,
        )
        return json.loads(out.stdout or b"{}")

    def decode_path(self, path) -> Optional[Dict]:
        try:
            info = self._probe(path)
            vstream = next(
                (s for s in info.get("streams", []) if s["codec_type"] == "video"),
                None,
            )
            if vstream is None:
                return None
            fps = eval_fraction(vstream.get("avg_frame_rate", "30/1"))
            s = self.size
            vf = (
                f"scale=w={s}:h={s}:force_original_aspect_ratio=increase,"
                f"crop={s}:{s}"
            )
            vproc = subprocess.run(
                [self.ffmpeg, "-v", "error", "-i", str(path), "-vf", vf,
                 "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
                capture_output=True,
            )
            frames = np.frombuffer(vproc.stdout, dtype=np.uint8)
            n = len(frames) // (s * s * 3)
            if n == 0:
                return None
            frames = frames[: n * s * s * 3].reshape(n, s, s, 3)
            aproc = subprocess.run(
                [self.ffmpeg, "-v", "error", "-i", str(path), "-ac", "1",
                 "-ar", str(self.sample_rate), "-f", "f32le", "-"],
                capture_output=True,
            )
            audio = np.frombuffer(aproc.stdout, dtype=np.float32)
            return {
                "frames": frames,
                "audio": audio.copy(),
                "sample_rate": self.sample_rate,
                "video_fps": float(fps),
            }
        except Exception:
            return None


def eval_fraction(s: str) -> float:
    """ffprobe's ``"num/den"`` rate (or a plain number) -> float; 0 for a
    zero denominator."""
    if "/" in s:
        num, den = s.split("/")
        den = float(den)
        return float(num) / den if den else 0.0
    return float(s)


class OpenCVVideoDecoder:
    """mp4/avi bytes -> frames through OpenCV's bundled FFmpeg, scaled and
    center-cropped like ``FfmpegCliDecoder``. OpenCV exposes no audio
    stream; ``audio_policy`` ``"silent"`` (default) gives zeros for the
    clip's duration, ``"drop"`` returns None so the clip is skipped."""

    def __init__(self, size: int = 256, sample_rate: int = 16000,
                 audio_policy: str = "silent"):
        if audio_policy not in ("silent", "drop"):
            raise ValueError(f"audio_policy {audio_policy!r}: 'silent' or 'drop'")
        self.size = size
        self.sample_rate = sample_rate
        self.audio_policy = audio_policy

    @property
    def available(self) -> bool:
        try:
            import cv2  # noqa: F401

            return True
        except ImportError:
            return False

    def __call__(self, data: bytes) -> Optional[Dict]:
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(data)
            f.flush()
            return self.decode_path(f.name)

    def _fit_frame(self, frame):
        import cv2

        h, w = frame.shape[:2]
        s = self.size
        scale = s / min(h, w)
        nh, nw = max(int(round(h * scale)), s), max(int(round(w * scale)), s)
        frame = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)
        y, x = (nh - s) // 2, (nw - s) // 2
        return frame[y : y + s, x : x + s]

    def decode_path(self, path) -> Optional[Dict]:
        import cv2

        try:
            cap = cv2.VideoCapture(str(path))
            if not cap.isOpened():
                return None
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            frames = []
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(self._fit_frame(frame))
            cap.release()
            if not frames:
                return None
            stack = np.stack(frames)
            if self.audio_policy == "drop":
                return None
            duration = len(frames) / fps
            audio = np.zeros(
                max(int(duration * self.sample_rate), 1), np.float32
            )
            return {
                "frames": stack,
                "audio": audio,
                "sample_rate": self.sample_rate,
                "video_fps": float(fps),
            }
        except Exception:
            return None


class NativeAvDecoder:
    """mp4 bytes -> frames and real audio through FFmpeg's libraries
    (``native_av``): in-memory demux, libavcodec video and AAC decode,
    swresample to mono ``sample_rate``. ``sample_frames`` > 0 keeps that
    many uniformly sampled frames (``temporal_sampling``'s rule, applied in
    C: every frame decodes, only the sampled ones are scaled and stored).

    Instances pickle, so they travel to spawned decode workers. Unlike the
    JAX package's, a call raises when the library could not be built,
    where the JAX package returns None and drops the clip without a word.
    """

    def __init__(self, size: int = 256, sample_rate: int = 16000,
                 sample_frames: int = 0):
        self.size = size
        self.sample_rate = sample_rate
        self.sample_frames = sample_frames

    @property
    def available(self) -> bool:
        from . import native_av

        return native_av.available()

    def __call__(self, data: bytes) -> Optional[Dict]:
        from . import native_av

        if not native_av.available():
            raise RuntimeError("the native FFmpeg library is unavailable: building "
                               "native/avio.cc needs g++ and FFmpeg's headers and "
                               "libraries")
        dec = native_av.decode(data=data, size=self.size,
                               sample_rate=self.sample_rate,
                               sample_frames=self.sample_frames)
        if dec is None or dec["frames"].shape[0] == 0:
            return None
        n = dec["frames"].shape[0]
        fps = float(dec["video_fps"]) or n / max(dec["duration"], 1e-6)
        if self.sample_frames and n == self.sample_frames:
            # sampled decode: an effective fps, so that frames / fps (the
            # skip rule of prepare_clip) is still the clip's true duration
            duration = dec["duration"] or (n / fps)
            fps = n / max(duration, 1e-6)
        return {
            "frames": dec["frames"],
            "audio": dec["audio"],
            "sample_rate": self.sample_rate,
            "video_fps": fps,
        }

    def decode_path(self, path) -> Optional[Dict]:
        with open(path, "rb") as f:
            return self(f.read())


def get_decoder(name: str = "npz", **kwargs):
    """``npz``, ``native``, ``ffmpeg``, ``opencv`` or ``auto``: the best mp4
    backend there is, in the JAX package's order (native, then the ffmpeg
    binary, then OpenCV, which is video only)."""
    if name == "npz":
        return decode_npz
    if name == "ffmpeg":
        return FfmpegCliDecoder(**kwargs)
    if name == "opencv":
        return OpenCVVideoDecoder(**kwargs)
    if name == "native":
        return NativeAvDecoder(**kwargs)
    if name == "auto":
        common = {k: v for k, v in kwargs.items()
                  if k in ("size", "sample_rate")}
        native = NativeAvDecoder(
            **{k: v for k, v in kwargs.items()
               if k in ("size", "sample_rate", "sample_frames")})
        if native.available:
            return native
        dec = FfmpegCliDecoder(**common)
        if dec.available:
            return dec
        return OpenCVVideoDecoder(**common)
    raise ValueError(f"unknown decoder {name!r}")


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
