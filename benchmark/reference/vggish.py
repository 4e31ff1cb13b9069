"""Plain VGGish with layer taps and its log-mel front end: the benchmark's
frozen reference.

The front end follows ``torchvggish``'s ``mel_features.py`` and
``vggish_input.py`` as written: 25 ms frames (400 samples) every 10 ms,
a periodic Hann window, the magnitude of a 512-point real FFT, the HTK
mel filterbank (64 bands, 125-7500 Hz, DC row zeroed), ``log(mel + 0.01)``,
then non-overlapping examples of 96 frames (0.96 s). It runs in float64
with ``torch.fft`` (the program computes the same spectrum as matrix
products). The network is torchvggish's (``features.{0,3,6,8,11,13}``,
``embeddings.{0,2,4}``); ACAV100M taps the spatial mean of each pool block
(64, 128, 256, 512) and the 128-d embedding, then averages each clip's
examples, counting only those its valid samples cover fully (the first
always counts). It imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

SR = 16000
WINDOW, HOP, FFT = 400, 160, 512
MELS, EXAMPLE = 64, 96
TAP_DIMS = [64, 128, 256, 512, 128]


def mel_matrix() -> np.ndarray:
    """(257, 64) HTK filterbank, as ``mel_features.spectrogram_to_mel_matrix``."""
    def mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)

    bins_mel = mel(np.linspace(0.0, SR / 2, FFT // 2 + 1))
    edges = np.linspace(mel(125.0), mel(7500.0), MELS + 2)
    w = np.empty((FFT // 2 + 1, MELS))
    for i in range(MELS):
        lo, c, hi = edges[i:i + 3]
        w[:, i] = np.maximum(0.0, np.minimum((bins_mel - lo) / (c - lo), (hi - bins_mel) / (hi - c)))
    w[0, :] = 0.0
    return w


def log_mel_examples(audio: torch.Tensor) -> torch.Tensor:
    """(B, S) waveforms -> (B, N, 96, 64) float64 log-mel examples."""
    x = audio.double()
    frames = x.unfold(-1, WINDOW, HOP)  # (B, F, 400)
    hann = 0.5 - 0.5 * torch.cos(2 * np.pi / WINDOW * torch.arange(
        WINDOW, dtype=torch.float64, device=x.device))
    spec = torch.fft.rfft(frames * hann, n=FFT).abs()  # (B, F, 257)
    mel = torch.as_tensor(mel_matrix(), device=x.device)
    log_mel = torch.log(spec @ mel + 0.01)
    n = 1 + (log_mel.shape[1] - EXAMPLE) // EXAMPLE
    return log_mel[:, :n * EXAMPLE].reshape(x.shape[0], n, EXAMPLE, MELS)


class VggishTaps(nn.Module):
    """(audio (B, S) float32, valid samples (B,)) -> five taps (B, dim)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 1
        for ch, n in [(64, 1), (128, 1), (256, 2), (512, 2)]:
            for _ in range(n):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.embeddings = nn.Sequential(nn.Linear(512 * 4 * 6, 4096), nn.ReLU(),
                                        nn.Linear(4096, 4096), nn.ReLU(),
                                        nn.Linear(4096, 128), nn.ReLU())
        self.eval()

    def forward(self, audio: torch.Tensor, valid: torch.Tensor) -> List[torch.Tensor]:
        b, s = audio.shape
        ex = log_mel_examples(audio).float()  # (B, N, 96, 64)
        n = ex.shape[1]
        x = ex.reshape(b * n, 1, EXAMPLE, MELS)
        taps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                taps.append(x.mean((2, 3)))
        taps.append(self.embeddings(x.permute(0, 2, 3, 1).reshape(b * n, -1)))
        per = int(round(0.96 * SR))
        idx = torch.arange(n, device=audio.device)
        mask = (((idx + 1) * per <= valid[:, None]) | (idx == 0)).float()[..., None]
        return [(t.reshape(b, n, -1) * mask).sum(1) / mask.sum(1).clamp(min=1.0)
                for t in taps]
