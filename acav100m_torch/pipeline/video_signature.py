"""MPEG-7 video-signature perceptual similarity (vf_signature port).

A copy of ``acav100m_tpu/pipeline/video_signature.py`` (the port imports nothing of
the JAX package).

The reference measures clip-pair similarity by running ffmpeg's
``signature=detectmode=full:nb_inputs=2`` filter and parsing the MATCHED
FRAME COUNT from its log line (``clip_segmentation/code/extract_clips.py:
97-107``); the count steers the stage-3 diversity samplers. libavfilter is
may be absent, so this module implements the same algorithm family
(ISO/IEC 15938-3 video signature as realized in ffmpeg's vf_signature)
from scratch over decoded frames:

1. **Per frame**: Rec.601 luma, area-averaged to a 32x32 grid (exact
   block means via summed-area boundaries, like the filter's block sums).
2. **Fine signature**: 380 'elementary differences' — each the difference
   of mean intensity between two sets of rectangles on the grid —
   quantized to ternary {0,1,2} at a per-frame adaptive threshold (the
   median absolute difference).
3. **Frame-pair distance**: L1 over the ternary vector; pairs below a
   threshold are match candidates (the filter's fine-signature l1
   comparison).
4. **detectmode=full semantics**: the reported similarity is the largest
   TEMPORALLY CONSISTENT candidate set — a Hough vote over the frame
   offset ``j - i`` with +-1 jitter — mirroring the filter's constant-
   offset matching sequence search, returned as the matched-frame count.

Documented divergence: the MPEG-7 spec pins a normative table
of 380 block-pair geometries and per-dimension quantization thresholds;
those constants are not reproduced here (no libavfilter source). The table here is generated deterministically (seed 15938) from
the same geometry family — rectangles of size 1..8 on the 32x32 grid, 1..4
rectangles per side. The metric's invariances (identity -> all frames
match; temporal shift -> overlap matches; unrelated/shuffled content ->
few) are property-tested in ``tests/test_video_signature.py``; where an
ffmpeg binary exists the ``FfmpegVideoBackend`` still runs the real
filter.
"""

from __future__ import annotations

import functools

import numpy as np

GRID = 32
N_FEATURES = 380  # the MPEG-7 fine-signature dimensionality
TABLE_SEED = 15938  # ISO/IEC 15938 (MPEG-7)
# candidate threshold on the ternary L1 distance (max possible = 2*380):
# unrelated frames measure ~0.75/dim (see tests), near-duplicates ~0
L1_THRESHOLD = 0.15 * 2 * N_FEATURES


@functools.lru_cache(maxsize=None)
def _feature_bank() -> np.ndarray:
    """(N_FEATURES, GRID*GRID) float32 weights: +1/|A| over the A rects,
    -1/|B| over the B rects — features are one matmul per frame."""
    rng = np.random.RandomState(TABLE_SEED)
    bank = np.zeros((N_FEATURES, GRID, GRID), np.float32)

    def paint(w, sign):
        n_rects = rng.randint(1, 5)
        mask = np.zeros((GRID, GRID), bool)
        for _ in range(n_rects):
            bh, bw = rng.randint(1, 9), rng.randint(1, 9)
            y = rng.randint(0, GRID - bh + 1)
            x = rng.randint(0, GRID - bw + 1)
            mask[y:y + bh, x:x + bw] = True
        w[mask] += sign / max(mask.sum(), 1)

    for f in range(N_FEATURES):
        paint(bank[f], +1.0)
        paint(bank[f], -1.0)
    return bank.reshape(N_FEATURES, GRID * GRID)


def luma_grid(frames: np.ndarray) -> np.ndarray:
    """(T,H,W[,3]) -> (T,GRID,GRID) float32 area-averaged luma."""
    frames = np.asarray(frames)
    if frames.ndim == 4:
        f = frames.astype(np.float32)
        luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    else:
        luma = frames.astype(np.float32)
    t, h, w = luma.shape
    if h < GRID:  # upsample tiny inputs so block boundaries stay valid
        luma = np.repeat(luma, -(-GRID // h), axis=1)
        h = luma.shape[1]
    if w < GRID:
        luma = np.repeat(luma, -(-GRID // w), axis=2)
        w = luma.shape[2]
    # block boundaries round(i*H/GRID), exact block means via reduceat
    yb = (np.arange(GRID) * h) // GRID
    xb = (np.arange(GRID) * w) // GRID
    ys = np.add.reduceat(luma, yb, axis=1)
    sums = np.add.reduceat(ys, xb, axis=2)
    yc = np.diff(np.append(yb, h)).astype(np.float32)
    xc = np.diff(np.append(xb, w)).astype(np.float32)
    return sums / (yc[None, :, None] * xc[None, None, :])


def fine_signatures(frames: np.ndarray) -> np.ndarray:
    """(T,H,W[,3]) -> (T, N_FEATURES) ternary int8 in {0,1,2}."""
    grid = luma_grid(frames).reshape(-1, GRID * GRID)  # (T, 1024)
    feats = grid @ _feature_bank().T  # (T, N_FEATURES)
    # per-frame adaptive ternarization threshold: median |difference|
    th = np.median(np.abs(feats), axis=1, keepdims=True)
    sig = np.ones(feats.shape, np.int8)
    sig[feats > th] = 2
    sig[feats < -th] = 0
    return sig


def matched_frames(sig_a: np.ndarray, sig_b: np.ndarray,
                   l1_threshold: float = L1_THRESHOLD) -> int:
    """Matched-frame count between two fine-signature sequences.

    Candidate pairs have ternary L1 distance below ``l1_threshold``; the
    count is the best Hough vote over the frame offset (+-1 jitter), i.e.
    the largest temporally consistent matching sequence — the
    ``detectmode=full`` 'X frames matching' number."""
    ta, tb = sig_a.shape[0], sig_b.shape[0]
    if ta == 0 or tb == 0:
        return 0
    a = sig_a.astype(np.int16)
    b = sig_b.astype(np.int16)
    # L1 over ternary values via per-frame pair expansion (T_a, T_b)
    dist = np.abs(a[:, None, :] - b[None, :, :]).sum(axis=-1)
    cand = dist < l1_threshold
    if not cand.any():
        return 0
    # Hough over offsets d = j - i with +-1 jitter, counting UNIQUE source
    # frames per offset band (one-to-one along the matching sequence, like
    # the filter's constant-offset path — a dense within-scene candidate
    # block must not count the same frame twice)
    ii = np.arange(ta)
    best = 0
    for d in range(-(ta - 1), tb):
        ok = np.zeros(ta, bool)
        for jj in (ii + d - 1, ii + d, ii + d + 1):
            valid = (jj >= 0) & (jj < tb)
            ok[valid] |= cand[ii[valid], jj[valid]]
        best = max(best, int(ok.sum()))
    return best


def signature_similarity(frames_a: np.ndarray, frames_b: np.ndarray,
                         l1_threshold: float = L1_THRESHOLD) -> int:
    """Decoded frames -> matched-frame count (the reference's similarity
    value, extract_clips.py:106-107)."""
    return matched_frames(
        fine_signatures(frames_a), fine_signatures(frames_b),
        l1_threshold=l1_threshold,
    )
