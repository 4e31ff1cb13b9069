"""Stage 3 — shot-boundary detection + diverse 10 s clip extraction.

A copy of ``acav100m_tpu/pipeline/clip_segmentation.py`` (the port imports nothing of
the JAX package).

Rebuild of ``clip_segmentation/code/extract_clips.py`` behind a backend
protocol:

* ``FfmpegVideoBackend`` — the reference's path: ffmpeg ``scdet`` SBD,
  stream-copy clip extraction, ``signature`` perceptual similarity
  (extract_clips.py:54-107). Gated on the ffmpeg binary.
* ``ArrayVideoBackend`` — decoded-array path for npz clips / tests: SBD by
  normalized inter-frame change (an scdet-alike).

All decoded-frame backends (Array/OpenCV/NativeAv) score similarity with
the MPEG-7 video-signature matched-frames metric (``video_signature.py``,
the vf_signature algorithm over decoded frames); ``FfmpegVideoBackend``
runs the real filter when a binary exists.

Algorithmics are exact ports: threshold annealing x1.2 until >= num_clips
valid shots or threshold >= 100 (extract_clips.py:199-213); valid shots
>= 10 s center-cropped to exactly 10 s; mean-clip fallback; num_clips
halved for short videos; diversity samplers ``diversity_greedy`` (default),
``minimum_pairwise``, sum-of-pairwise local search with swap gain
(1 + eps/n), ``random``, ``random_then_diversity`` (extract_clips.py:110-331).
"""

from __future__ import annotations

import math
import os
import random
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_SEED = 98052  # reference run.py:44


# -- backends -------------------------------------------------------------------

class FfmpegVideoBackend:
    """SBD/extract/similarity via the ffmpeg binary."""

    def __init__(self, in_filepath):
        self.path = str(in_filepath)
        self.ffmpeg = shutil.which("ffmpeg")
        self.ffprobe = shutil.which("ffprobe")
        if self.ffmpeg is None:
            raise RuntimeError("ffmpeg binary not found")

    def _run(self, cmd) -> str:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        return proc.stdout.decode("utf-8", errors="replace")

    def duration(self) -> float:
        out = self._run(
            [self.ffprobe, "-v", "error", "-show_entries", "format=duration",
             "-of", "default=noprint_wrappers=1:nokey=1", self.path]
        )
        try:
            return float(out.strip())
        except ValueError:
            return -1.0

    def detect_shots(self, threshold: float) -> Tuple[List[float], List[float]]:
        out = self._run(
            [self.ffmpeg, "-i", self.path, "-vf", f"scdet=threshold={threshold}",
             "-f", "null", "-"]
        )
        lines = [x.strip() for x in out.splitlines() if x.startswith("[scdet")]
        boundaries = [float(x.split(":")[-1]) for x in lines]
        scores = [float(x.split(":")[-2].split(",")[0]) for x in lines]
        return boundaries, scores

    def extract_clip(self, start: float, end: float, out_path) -> str:
        def hhmmss(sec):
            hh = int(sec // 3600)
            rem = sec % 3600
            return f"{hh:02d}:{int(rem // 60):02d}:{rem % 60:f}"

        self._run(
            [self.ffmpeg, "-ss", hhmmss(start), "-i", self.path, "-t",
             hhmmss(end - start), "-c", "copy", "-avoid_negative_ts", "1",
             "-reset_timestamps", "1", "-y", "-hide_banner", "-loglevel",
             "panic", "-map", "0", str(out_path)]
        )
        if not Path(out_path).is_file():
            raise RuntimeError(f"{out_path}: ffmpeg clip extraction failed")
        return str(out_path)

    def similarity(self, path_a, path_b) -> float:
        out = self._run(
            [self.ffmpeg, "-i", str(path_a), "-i", str(path_b), "-hide_banner",
             "-filter_complex", "signature=detectmode=full:nb_inputs=2",
             "-f", "null", "-"]
        )
        lines = [
            x for x in out.split("\n")
            if "Parsed_signature_0" in x and "frames matching" in x
        ]
        if not lines:
            return 0.0
        return int(lines[0].split(",")[-1].split()[0])


class ArrayVideoBackend:
    """Decoded frames (T,H,W,3) + fps: SBD by normalized frame change."""

    def __init__(self, frames: np.ndarray, fps: float, out_format: str = "npy"):
        self.frames = np.asarray(frames)
        self.fps = float(fps)
        self.out_format = out_format

    def duration(self) -> float:
        return self.frames.shape[0] / self.fps

    def detect_shots(self, threshold: float) -> Tuple[List[float], List[float]]:
        f = self.frames.astype(np.float32)
        diffs = np.abs(f[1:] - f[:-1]).mean(axis=(1, 2, 3))
        if diffs.size == 0:
            return [], []
        # scdet-style: score as % of max possible change
        scores = 100.0 * diffs / 255.0
        idx = np.where(scores >= threshold)[0]
        boundaries = [(i + 1) / self.fps for i in idx]
        return boundaries, [float(scores[i]) for i in idx]

    def _clip_array(self, start: float, end: float) -> np.ndarray:
        i0 = int(round(start * self.fps))
        i1 = max(int(round(end * self.fps)), i0 + 1)
        return self.frames[i0:i1]

    def extract_clip(self, start: float, end: float, out_path) -> str:
        out_path = str(out_path)
        np.save(out_path if out_path.endswith(".npy") else out_path + ".npy",
                self._clip_array(start, end))
        return out_path if out_path.endswith(".npy") else out_path + ".npy"

    def similarity(self, path_a, path_b) -> float:
        from .video_signature import signature_similarity

        return float(signature_similarity(np.load(path_a), np.load(path_b)))

class OpenCVVideoBackend:
    """Real-video stage-3 backend via OpenCV's BUNDLED FFmpeg (no external
    binary): decode once, SBD on the decoded frames (the ArrayVideoBackend
    scdet-style math), and clips re-encoded as REAL mp4 files (mp4v — the
    reference's ``-c copy`` stream copy needs the ffmpeg binary,
    extract_clips.py:88-94). Executes the full stage-3 contract on
    compressed video in environments without ffmpeg/PyAV."""

    def __init__(self, in_filepath):
        import cv2

        cap = cv2.VideoCapture(str(in_filepath))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open video {in_filepath}")
        self.fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frames:
            raise RuntimeError(f"no frames in {in_filepath}")
        self._arr = ArrayVideoBackend(np.stack(frames), self.fps)

    def duration(self) -> float:
        return self._arr.duration()

    def detect_shots(self, threshold: float) -> Tuple[List[float], List[float]]:
        return self._arr.detect_shots(threshold)

    def extract_clip(self, start: float, end: float, out_path) -> str:
        import cv2

        out_path = str(out_path)
        clip = self._arr._clip_array(start, end)
        h, w = clip.shape[1:3]
        writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
        )
        for frame in clip:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        return out_path

    def similarity(self, path_a, path_b) -> float:
        import cv2

        from .video_signature import signature_similarity

        def read_frames(path):
            cap = cv2.VideoCapture(str(path))
            frames = []
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            cap.release()
            if not frames:
                return np.zeros((0, 32, 32, 3), np.uint8)
            return np.stack(frames)

        return float(
            signature_similarity(read_frames(path_a), read_frames(path_b))
        )


class NativeAvVideoBackend:
    """Stage-3 backend on the native FFmpeg-library bindings
    (``data/native_av.py``): SBD from per-frame scdet scores computed on
    the decoded YUV planes by ``native/avio.cc`` (the exact mafd/diff math
    of ffmpeg's vf_scdet, which the reference drives via the binary,
    extract_clips.py:54-62), and clip extraction by keyframe-snapped
    stream copy (``av_remux_clip`` = ``ffmpeg -ss .. -c copy``,
    extract_clips.py:88-94). Decodes scores once; annealing just
    re-thresholds. Similarity = MPEG-7 video-signature matched-frame count
    over decoded clips (``video_signature.py`` — the vf_signature
    algorithm; the filter itself needs libavfilter)."""

    def __init__(self, in_filepath, sbd_size: int = 0):
        from ..data import native_av

        if not native_av.available():
            raise RuntimeError("native avio library unavailable")
        self._av = native_av
        self.path = str(in_filepath)
        dec = native_av.decode(path=self.path, size=sbd_size, sample_rate=0,
                               with_scores=True)
        if dec is None or dec["frames"].shape[0] == 0:
            raise RuntimeError(f"cannot decode video {in_filepath}")
        self.fps = float(dec["video_fps"]) or 30.0
        self._times = dec["frame_times"]
        self._scores = dec.get("scene_scores")
        self._duration = float(dec["duration"]) or (
            dec["frames"].shape[0] / self.fps)

    def duration(self) -> float:
        return self._duration

    def detect_shots(self, threshold: float) -> Tuple[List[float], List[float]]:
        if self._scores is None:
            return [], []
        idx = np.where(self._scores >= threshold)[0]
        boundaries = [
            float(self._times[i]) if self._times[i] >= 0 else i / self.fps
            for i in idx
        ]
        return boundaries, [float(self._scores[i]) for i in idx]

    def extract_clip(self, start: float, end: float, out_path) -> str:
        if not self._av.remux_clip(self.path, out_path, start, end - start):
            raise RuntimeError(f"{out_path}: native clip remux failed")
        return str(out_path)

    def similarity(self, path_a, path_b) -> float:
        from .video_signature import signature_similarity

        def read_frames(path):
            # decode at a small size: the signature grid is 32x32, so a
            # 64p decode preserves the block means while skipping most of
            # the sws_scale + storage cost
            dec = self._av.decode(path=path, size=64, sample_rate=0)
            if dec is None or dec["frames"].shape[0] == 0:
                return np.zeros((0, 64, 64, 3), np.uint8)
            return dec["frames"]

        return float(
            signature_similarity(read_frames(path_a), read_frames(path_b))
        )


def open_video_backend(path, backend: str = "auto"):
    """Best available real-video backend for ``path``: the native
    FFmpeg-library backend (full SBD + stream-copy extraction, no external
    binary), else the ffmpeg binary, else OpenCV (re-encoded clips)."""
    if backend == "native":
        return NativeAvVideoBackend(path)
    if backend == "ffmpeg":
        return FfmpegVideoBackend(path)
    if backend == "opencv":
        return OpenCVVideoBackend(path)
    if backend != "auto":
        raise ValueError(f"unknown video backend {backend!r}")
    from ..data import native_av

    if native_av.available():
        return NativeAvVideoBackend(path)
    if shutil.which("ffmpeg"):
        return FfmpegVideoBackend(path)
    return OpenCVVideoBackend(path)


# -- pure algorithmics (ports) -----------------------------------------------------

def get_valid_clips(sb: List[float], min_duration: float,
                    force_duration: bool = False) -> List[List[float]]:
    """Shots >= min_duration, center-cropped to exactly min_duration
    (extract_clips.py:65-78)."""
    sb = [0.0] + list(sb)
    shots = [[sb[i - 1], sb[i]] for i in range(1, len(sb))]
    valid = [s for s in shots if s[1] - s[0] >= min_duration]
    if force_duration:
        for clip in valid:
            delta = 0.5 * ((clip[1] - clip[0]) - min_duration)
            clip[0] = clip[0] + delta
            clip[1] = clip[0] + min_duration
    return valid


def get_mean_clip(full_duration: float, min_duration: float) -> List[float]:
    assert full_duration >= min_duration, "clip duration shorter than min duration"
    mean = full_duration / 2
    pad = min_duration / 2
    return [mean - pad, mean + pad]


def calc_pairwise_distance(sim: np.ndarray, num_clips: int) -> List[int]:
    """Greedy minimum-pairwise-similarity (extract_clips.py:117-127)."""
    keep = [0]
    if num_clips == 1:
        return keep
    for _ in range(num_clips - 1):
        row = np.argsort(sim[keep[-1]])
        row = np.setdiff1d(row, np.array(keep))
        keep.append(int(row[0]))
    return keep


def calc_sum_of_pairwise_distance(sim: np.ndarray, num_clips: int,
                                  eps: float = 0.1,
                                  big_number: float = 1e10) -> List[int]:
    """Local-search with swap gain 1 + eps/n (extract_clips.py:130-173)."""
    gain_coeff = 1 + eps / sim.shape[0]
    min_set = set(int(v) for v in np.unravel_index(sim.argmin(), sim.shape))
    diff = num_clips - len(min_set)
    if diff <= 0:
        return list(min_set)[:num_clips]
    rest = list(set(range(sim.shape[0])) - min_set)[:diff]
    current = list(set(rest) | min_set)
    assert len(current) == num_clips, "diversity init failed"
    swapped = True
    while swapped:
        swapped = False
        for i in range(num_clips):
            idx = current[i]
            others = list(set(current) - {idx})
            rest_sum = sim[others].sum(axis=0)
            rest_sum[others] = big_number
            min_idx = int(rest_sum.argmin())
            if gain_coeff * rest_sum[min_idx] < rest_sum[idx]:
                current.remove(idx)
                current.append(min_idx)
                swapped = True
                break
    return list(current)


def calc_diversity(sim: np.ndarray, num_clips: int, calc_sum: bool = True):
    if calc_sum:
        return calc_sum_of_pairwise_distance(sim, num_clips)
    return calc_pairwise_distance(sim, num_clips)


# -- the per-video entry point --------------------------------------------------------

def segment_video(
    backend,
    out_dir,
    video_name: str,
    num_clips: int = 3,
    threshold: float = 10.0,
    clip_duration: float = 10.0,
    clip_duration_threshold: Sequence[float] = (60.0,),
    force_duration: bool = True,
    force_num_clips: bool = True,
    anneal_factor: float = 1.2,
    sampling: str = "diversity_greedy",
    cut_random_clips: Optional[int] = None,
    calc_diversity_with_sum: bool = False,
    rng: Optional[random.Random] = None,
) -> Tuple[List[List[float]], List[str]]:
    """Segment one video into <= num_clips diverse clips
    (extract_clips.py:176-335). Returns (clips, out_filepaths)."""
    if rng is None:
        rng = random.Random(DEFAULT_SEED)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    orig_duration = backend.duration()
    # halve num_clips for short videos (extract_clips.py:191-197)
    for constraint in sorted(clip_duration_threshold):
        if orig_duration <= constraint:
            num_clips = math.ceil(num_clips / 2 ** (len(clip_duration_threshold) - 1))
            break
    num_clips = max(num_clips, 1)

    # threshold annealing (extract_clips.py:199-213)
    threshold = float(threshold)
    valid_clips: List[List[float]] = []
    while True:
        sb, _ = backend.detect_shots(threshold)
        if sb:
            valid_clips = get_valid_clips(sb, clip_duration, force_duration)
        if len(valid_clips) >= num_clips or not force_num_clips or threshold >= 100.0:
            break
        threshold = min(anneal_factor * threshold, 100.0)

    if not valid_clips:
        # mean-clip fallback (extract_clips.py:215-223)
        du_ = backend.duration()
        sb = [0.0, du_]
        if force_duration:
            delta = 0.5 * ((sb[1] - sb[0]) - clip_duration)
            sb = [sb[0] + delta, sb[0] + delta + clip_duration]
        valid_clips = [sb]

    def save_clip(clip) -> str:
        out_path = out_dir / f"{video_name}_{int(clip[0]):03d}.mp4"
        if not Path(out_path).is_file():
            return backend.extract_clip(clip[0], clip[1], out_path)
        return str(out_path)

    if force_num_clips and len(valid_clips) > num_clips and sampling == "random":
        valid_clips = sorted(rng.sample(valid_clips, num_clips))

    if sampling == "diversity" and cut_random_clips is not None:
        # reference quirk reproduced: samples num_clips (not
        # cut_random_clips) then cuts, so with the asserted
        # cut_random_clips >= num_clips the cut is a no-op and diversity
        # runs on a random num_clips-subset (extract_clips.py:257-259)
        assert cut_random_clips >= num_clips, \
            "cut_random clips should be larger than num_clips"
        valid_clips = sorted(rng.sample(valid_clips, num_clips))[:cut_random_clips]

    if sampling == "diversity_greedy":
        # incremental min-similarity greedy (extract_clips.py:261-291)
        rng.shuffle(valid_clips)
        if len(valid_clips) <= num_clips:
            paths = [save_clip(c) for c in valid_clips]
            return valid_clips, paths
        current = [valid_clips[0]]
        others = list(valid_clips[1:])
        paths = [save_clip(current[-1])]
        for _ in range(num_clips - 1):
            min_sim, cand = float("inf"), 0
            for i, other in enumerate(others):
                other_path = save_clip(other)
                sim = sum(backend.similarity(p, other_path) for p in paths)
                os.remove(other_path)
                if sim == 0:
                    cand = i
                    break
                if sim < min_sim:
                    cand, min_sim = i, sim
            current.append(others.pop(cand))
            paths.append(save_clip(current[-1]))
        return current, paths

    # extract everything, then subsample
    paths = [save_clip(c) for c in valid_clips]
    keep_idx = list(range(len(valid_clips)))
    if force_num_clips and len(valid_clips) > num_clips:
        if sampling == "diversity":
            n = len(valid_clips)
            sim = np.zeros((n, n))
            # reference quirk reproduced: the PATH list is shuffled before
            # the similarity matrix is built, but keep_idx still indexes
            # the UNshuffled valid_clips for the returned intervals — the
            # kept files and kept intervals are decoupled by design
            # upstream (extract_clips.py:305,333)
            rng.shuffle(paths)
            for i in range(n - 1):
                for j in range(i + 1, n):
                    sim[i, j] = backend.similarity(paths[i], paths[j])
            sim = sim + sim.T
            keep_idx = calc_diversity(sim, num_clips,
                                      calc_sum=calc_diversity_with_sum)
            for i in range(n):
                if i not in keep_idx:
                    os.remove(paths[i])
        elif sampling in ("random_then_diversity", "random1_then_diversity"):
            rng.shuffle(paths)
            random_clips = 1 if sampling == "random1_then_diversity" else math.ceil(num_clips / 2)
            diversity_clips = num_clips - random_clips
            keep_idx = list(range(random_clips))
            n = len(valid_clips)
            sim = np.zeros((random_clips, n - random_clips))
            for i in range(random_clips):
                for j in range(n - random_clips):
                    sim[i, j] = backend.similarity(paths[i], paths[j + random_clips])
            div_idx = np.argsort(sim.sum(axis=0))[:diversity_clips] + random_clips
            keep_idx += [int(v) for v in div_idx]
            for i in range(n):
                if i not in keep_idx:
                    os.remove(paths[i])
    clips = [valid_clips[i] for i in keep_idx]
    paths = [paths[i] for i in keep_idx]
    return clips, paths
