"""ctypes bindings for the native FFmpeg media IO library (``native/avio.cc``).

A copy of ``acav100m_tpu/data/native_av.py`` (the port imports nothing of
the JAX package). ``native_build`` compiles the source with g++ against
FFmpeg's libraries into ``build/`` at first use; where FFmpeg's headers or
libraries are missing, ``available()`` is False.

* :func:`decode`: demux and decode video AND audio from a path or an
  in-memory buffer (tar members never touch disk). Frames come back
  short-side scaled and center-cropped RGB24 at a static size; audio comes
  back mono float32 at the requested rate (libswresample). Optional
  per-frame scene scores (the mafd/diff math of ffmpeg's vf_scdet).
* :func:`remux_clip`: keyframe-snapped stream copy of ``[start,
  start+dur)`` into a new mp4, the ``ffmpeg -ss .. -c copy`` equivalent.
* :func:`encode_mp4`: mpeg4 + AAC mp4 writer from raw arrays (libavcodec's
  own encoders), so tests and the smoke run make real compressed media
  from seeds.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .native_build import build_library

_lock = threading.Lock()
_lib = None
_load_failed = False

_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample", "-lswscale"]


class _AvDecoded(ctypes.Structure):
    _fields_ = [
        ("frames", ctypes.POINTER(ctypes.c_uint8)),
        ("n_frames", ctypes.c_int64),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("fps", ctypes.c_double),
        ("frame_times", ctypes.POINTER(ctypes.c_double)),
        ("scene_scores", ctypes.POINTER(ctypes.c_double)),
        ("audio", ctypes.POINTER(ctypes.c_float)),
        ("n_samples", ctypes.c_int64),
        ("sample_rate", ctypes.c_int32),
        ("duration", ctypes.c_double),
        ("audio_start", ctypes.c_double),
        ("err", ctypes.c_char * 256),
    ]


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build_library("avio", libs=_LIBS)
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        c = ctypes
        lib.av_decode.argtypes = [
            c.c_char_p, c.POINTER(c.c_uint8), c.c_int64, c.c_int32,
            c.c_int32, c.c_int64, c.c_int32, c.c_int64, c.c_int32,
            c.POINTER(_AvDecoded),
        ]
        lib.av_decode.restype = c.c_int
        lib.av_decoded_free.argtypes = [c.POINTER(_AvDecoded)]
        lib.av_decoded_free.restype = None
        lib.av_remux_clip.argtypes = [
            c.c_char_p, c.c_char_p, c.c_double, c.c_double, c.c_char_p,
        ]
        lib.av_remux_clip.restype = c.c_int
        lib.av_encode_mp4.argtypes = [
            c.c_char_p, c.POINTER(c.c_uint8), c.c_int64, c.c_int32,
            c.c_int32, c.c_double, c.POINTER(c.c_float), c.c_int64,
            c.c_int32, c.c_char_p,
        ]
        lib.av_encode_mp4.restype = c.c_int
        lib.av_probe_version.argtypes = []
        lib.av_probe_version.restype = c.c_uint
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decode(
    data: Optional[bytes] = None,
    path=None,
    size: int = 0,
    sample_rate: int = 16000,
    max_frames: int = 0,
    with_scores: bool = False,
    sample_frames: int = 0,
    threads: int = 1,
) -> Optional[Dict]:
    """Decode media to arrays.

    Returns ``{frames (T,H,W,3) uint8, frame_times (T,), audio (S,) f32,
    sample_rate, video_fps, duration, audio_start[, scene_scores (T,)]}``
    or None. ``sample_rate=0`` skips the audio stream. ``sample_frames>0``
    keeps only that many uniformly sampled frames (floor-linspace, the
    ``temporal_sampling`` rule): every frame still decodes, but only the
    sampled ones pay scaling and storage.
    """
    lib = get_lib()
    if lib is None:
        return None
    out = _AvDecoded()
    if data is not None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        rc = lib.av_decode(None, buf, len(data), size, sample_rate,
                           max_frames, int(with_scores), sample_frames,
                           threads, ctypes.byref(out))
    else:
        rc = lib.av_decode(str(path).encode(), None, 0, size, sample_rate,
                           max_frames, int(with_scores), sample_frames,
                           threads, ctypes.byref(out))
    try:
        if rc != 0:
            return None
        result: Dict = {
            "video_fps": float(out.fps),
            "duration": float(out.duration),
            "sample_rate": int(out.sample_rate),
            # first audio sample's pts (>= 0): samples before the window are
            # trimmed in C; a late audio start is reported, not padded
            "audio_start": float(out.audio_start),
        }
        if out.n_frames > 0:
            shape = (out.n_frames, out.height, out.width, 3)
            result["frames"] = np.ctypeslib.as_array(out.frames, shape=shape).copy()
            result["frame_times"] = np.ctypeslib.as_array(
                out.frame_times, shape=(out.n_frames,)).copy()
            if with_scores and out.scene_scores:
                result["scene_scores"] = np.ctypeslib.as_array(
                    out.scene_scores, shape=(out.n_frames,)).copy()
        else:
            result["frames"] = np.zeros((0, 0, 0, 3), np.uint8)
        if out.n_samples > 0:
            result["audio"] = np.ctypeslib.as_array(
                out.audio, shape=(out.n_samples,)).copy()
        else:
            result["audio"] = np.zeros(0, np.float32)
        return result
    finally:
        lib.av_decoded_free(ctypes.byref(out))


def remux_clip(in_path, out_path, start: float, duration: float) -> bool:
    """``ffmpeg -ss start -i in -t duration -c copy out`` equivalent."""
    lib = get_lib()
    if lib is None:
        return False
    err = ctypes.create_string_buffer(256)
    rc = lib.av_remux_clip(str(in_path).encode(), str(out_path).encode(),
                           float(start), float(duration), err)
    return rc == 0 and Path(out_path).is_file()


def encode_mp4(path, frames: Optional[np.ndarray], fps: float = 30.0,
               audio: Optional[np.ndarray] = None,
               sample_rate: int = 16000) -> bool:
    """Write an mp4 with mpeg4 video and/or AAC audio from raw arrays."""
    lib = get_lib()
    if lib is None:
        return False
    err = ctypes.create_string_buffer(256)
    if frames is not None and len(frames):
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        n, h, w = frames.shape[:3]
        fptr = frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        n = h = w = 0
        fptr = None
    if audio is not None and len(audio):
        audio = np.ascontiguousarray(audio, dtype=np.float32)
        aptr = audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        ns = len(audio)
    else:
        aptr = None
        ns = 0
    rc = lib.av_encode_mp4(str(path).encode(), fptr, n, w, h, float(fps),
                           aptr, ns, sample_rate, err)
    return rc == 0
