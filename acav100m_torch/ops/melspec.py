"""VGGish log-mel front end as matrix products (PyTorch).

Port of ``acav100m_tpu/ops/melspec.py`` (reference
``utils_vggish/mel_features.py:21-223`` and ``preprocess.py:14-96``):
framing, periodic Hann window, |rfft| written as two products against
windowed cos/sin DFT bases, the HTK mel filterbank, ``log(mel + 0.01)``
and 0.96 s examples. The bases are built in float64 with numpy and cast to
the signal's dtype, as in the JAX package. The products are plain
``torch.matmul``: in float32 on the card they run in full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

SAMPLE_RATE = 16000
STFT_WINDOW_SECONDS = 0.025
STFT_HOP_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(frequencies_hertz):
    """HTK mel scale (reference mel_features.py:100-111)."""
    return _MEL_HIGH_FREQUENCY_Q * np.log(
        1.0 + (np.asarray(frequencies_hertz, dtype=np.float64) / _MEL_BREAK_FREQUENCY_HERTZ)
    )


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window (reference mel_features.py:48-68)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi / window_length * np.arange(window_length))


@functools.lru_cache(maxsize=None)
def mel_matrix(
    num_mel_bins: int = NUM_MEL_BINS,
    num_spectrogram_bins: int = 257,
    audio_sample_rate: int = SAMPLE_RATE,
    lower_edge_hertz: float = MEL_MIN_HZ,
    upper_edge_hertz: float = MEL_MAX_HZ,
) -> np.ndarray:
    """HTK triangular mel filterbank, (num_spectrogram_bins, num_mel_bins),
    DC bin zeroed (reference mel_features.py:114-189)."""
    nyquist = audio_sample_rate / 2.0
    if lower_edge_hertz < 0.0 or lower_edge_hertz >= upper_edge_hertz:
        raise ValueError("bad mel edges")
    if upper_edge_hertz > nyquist:
        raise ValueError("upper_edge_hertz above Nyquist")
    spectrogram_bins_mel = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    band_edges_mel = np.linspace(
        hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz),
        num_mel_bins + 2,
    )
    weights = np.empty((num_spectrogram_bins, num_mel_bins))
    for i in range(num_mel_bins):
        lower, center, upper = band_edges_mel[i : i + 3]
        lower_slope = (spectrogram_bins_mel - lower) / (center - lower)
        upper_slope = (upper - spectrogram_bins_mel) / (upper - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0
    weights.setflags(write=False)
    return weights


@functools.lru_cache(maxsize=None)
def windowed_dft_bases(window_length: int, fft_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(window x bins) cos/sin bases with the Hann window folded in:
    ``frames @ cos`` == Re(rfft(frames * hann)) and ``frames @ sin`` == its
    -Im."""
    bins = fft_length // 2 + 1
    n = np.arange(window_length)[:, None]
    k = np.arange(bins)[None, :]
    angle = 2.0 * np.pi * n * k / fft_length
    window = periodic_hann(window_length)[:, None]
    cos_b, sin_b = np.cos(angle) * window, -np.sin(angle) * window
    cos_b.setflags(write=False)
    sin_b.setflags(write=False)
    return cos_b, sin_b


def num_frames(num_samples: int, window_length: int, hop_length: int) -> int:
    return 1 + int(np.floor((num_samples - window_length) / hop_length))


def frame_signal(x: Tensor, window_length: int, hop_length: int) -> Tensor:
    """Overlapping frames of the last axis: (..., S) -> (..., F, window)."""
    return x.unfold(-1, window_length, hop_length)


def stft_magnitude(signal: Tensor, fft_length: int, hop_length: int,
                   window_length: int) -> Tensor:
    """|STFT| as matrix products. signal: (..., S) -> (..., F, bins)."""
    frames = frame_signal(signal, window_length, hop_length)
    cos_b, sin_b = windowed_dft_bases(window_length, fft_length)
    basis = torch.as_tensor(np.concatenate([cos_b, sin_b], axis=1),
                            dtype=frames.dtype, device=frames.device)
    proj = torch.matmul(frames, basis)
    bins = fft_length // 2 + 1
    re, im = proj[..., :bins], proj[..., bins:]
    return torch.sqrt(re * re + im * im)


def log_mel_spectrogram(signal: Tensor, audio_sample_rate: int = SAMPLE_RATE,
                        log_offset: float = LOG_OFFSET,
                        window_length_secs: float = STFT_WINDOW_SECONDS,
                        hop_length_secs: float = STFT_HOP_SECONDS,
                        num_mel_bins: int = NUM_MEL_BINS,
                        lower_edge_hertz: float = MEL_MIN_HZ,
                        upper_edge_hertz: float = MEL_MAX_HZ) -> Tensor:
    """(..., S) waveform -> (..., F, num_mel_bins) log-mel."""
    window_length = int(round(audio_sample_rate * window_length_secs))
    hop_length = int(round(audio_sample_rate * hop_length_secs))
    fft_length = 2 ** int(np.ceil(np.log(window_length) / np.log(2.0)))
    spec = stft_magnitude(signal, fft_length, hop_length, window_length)
    mel = torch.tensor(
        mel_matrix(num_mel_bins=num_mel_bins,
                   num_spectrogram_bins=fft_length // 2 + 1,
                   audio_sample_rate=audio_sample_rate,
                   lower_edge_hertz=lower_edge_hertz,
                   upper_edge_hertz=upper_edge_hertz),
        dtype=spec.dtype, device=spec.device)
    return torch.log(torch.matmul(spec, mel) + log_offset)


def vggish_num_examples(num_samples: int, sample_rate: int = SAMPLE_RATE) -> int:
    window_length = int(round(sample_rate * STFT_WINDOW_SECONDS))
    hop_length = int(round(sample_rate * STFT_HOP_SECONDS))
    nf = num_frames(num_samples, window_length, hop_length)
    example_len = int(round(EXAMPLE_WINDOW_SECONDS / STFT_HOP_SECONDS))
    example_hop = int(round(EXAMPLE_HOP_SECONDS / STFT_HOP_SECONDS))
    return 1 + int(np.floor((nf - example_len) / example_hop))


def vggish_examples(signal_16k: Tensor) -> Tensor:
    """16 kHz mono waveform (..., S) -> (..., N, 96, 64) log-mel examples
    (0.96 s non-overlapping windows, reference preprocess.py:58-89)."""
    log_mel = log_mel_spectrogram(signal_16k)
    example_len = int(round(EXAMPLE_WINDOW_SECONDS / STFT_HOP_SECONDS))  # 96
    example_hop = int(round(EXAMPLE_HOP_SECONDS / STFT_HOP_SECONDS))  # 96
    nf = log_mel.shape[-2]
    n_examples = 1 + int(np.floor((nf - example_len) / example_hop))
    if n_examples < 1:
        raise ValueError(f"too few frames ({nf}) for one 0.96 s example")
    used = (n_examples - 1) * example_hop + example_len
    log_mel = log_mel[..., :used, :]
    return log_mel.reshape(*log_mel.shape[:-2], n_examples, example_len,
                           log_mel.shape[-1])


def example_valid_mask(valid_samples: Tensor, total_samples: int,
                       sample_rate: int = SAMPLE_RATE) -> Tensor:
    """Mask (..., N) of the examples fully covered by ``valid_samples``;
    the first example always counts (reference keeps >= 1 frame)."""
    n_examples = vggish_num_examples(total_samples, sample_rate)
    samples_per_example = int(round(EXAMPLE_WINDOW_SECONDS * sample_rate))
    idx = torch.arange(n_examples, device=valid_samples.device)
    full = (idx + 1) * samples_per_example <= valid_samples[..., None]
    return (full | (idx == 0)).to(torch.float32)
