"""VGGish audio feature extractor (PyTorch).

Port of ``acav100m_tpu/models/vggish.py``: the torch.hub
``harritaylor/torchvggish`` architecture the reference wraps
(``feature_extraction/code/models/vggish.py:40-141``), with its parameter
names (``features.{0,3,6,8,11,13}``, ``embeddings.{0,2,4}``):

    features:   conv64-pool / conv128-pool / conv256-conv256-pool /
                conv512-conv512-pool          (3x3 convs, ReLU, 2x2 max pool)
    embeddings: 12288 -> 4096 -> 4096 -> 128 (ReLU after each)

``LayerVggish`` taps each pool block (spatial mean -> [64,128,256,512])
and the 128-d embedding, then takes masked means over the 0.96 s examples
of each clip (``vggish.py:92-112``).

``dtype`` (float32 or bfloat16) is the compute dtype of the conv stack and
the embeddings, as the JAX ``VGGishBackbone.dtype`` (``vggish.py:42-66``):
parameters stay float32 and each layer casts its weights at the call
(``models.in_dtype``). The log-mel front end stays float32, and so do the
masked example means, taken against a float32 mask as JAX takes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from . import compute_dtype, in_dtype, register_model
from ..ops import melspec

LAYER_DIMS = [64, 128, 256, 512, 128]
EMBED_DIM = 128

_CONV_KEYS = [  # torchvggish index -> flax module name
    ("features.0", "block0_conv0"),
    ("features.3", "block1_conv0"),
    ("features.6", "block2_conv0"),
    ("features.8", "block2_conv1"),
    ("features.11", "block3_conv0"),
    ("features.13", "block3_conv1"),
]
_FC_KEYS = [
    ("embeddings.0", "fc0"),
    ("embeddings.2", "fc1"),
    ("embeddings.4", "fc2"),
]


def _features() -> nn.Sequential:
    layers: List[nn.Module] = []
    cin = 1
    for ch, n_convs in [(64, 1), (128, 1), (256, 2), (512, 2)]:
        for _ in range(n_convs):
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU(inplace=True)]
            cin = ch
        layers.append(nn.MaxPool2d(2, 2))
    return nn.Sequential(*layers)


class VGGishBackbone(nn.Module):
    """features + embeddings; returns per-block spatial means and the
    embedding in ``dtype``. Input (N, 1, 96, 64) log-mel examples, cast to
    ``dtype`` on the way in."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.features = _features()
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 4 * 6, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, EMBED_DIM), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps: List[torch.Tensor] = []
        x = x.to(self.dtype)
        for layer in self.features:
            x = in_dtype(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
            if isinstance(layer, nn.MaxPool2d):
                taps.append(x.mean(dim=(2, 3)))
        # (H, W, C) flattening, as torchvggish (vggish.py:119-124)
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for layer in self.embeddings:
            h = in_dtype(layer, h) if isinstance(layer, nn.Linear) else layer(h)
        taps.append(h)
        return taps


@register_model("layer_vggish")
class LayerVggish(VGGishBackbone):
    """Layer-tapped VGGish over batches of 16 kHz mono clips (B, S) (+
    optional valid-sample counts of zero-padded short clips). Returns 5
    tensors (B, dim), dims [64, 128, 256, 512, 128]. Parameters carry the
    torchvggish names (``features.0.weight``, ...)."""

    output_dims = LAYER_DIMS
    model_tag = {"name": "VGGish", "dataset": "YouTube-8M"}
    media_type = "audio"

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self.eval()

    def forward(self, audio: torch.Tensor,
                valid_samples: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        b, s = audio.shape
        examples = melspec.vggish_examples(audio)  # (B, N, 96, 64)
        n = examples.shape[1]
        taps = VGGishBackbone.forward(self, examples.reshape(b * n, 1, 96, 64))
        # the mask is in the examples' float32, so the means are float32
        if valid_samples is None:
            mask = torch.ones((b, n, 1), dtype=examples.dtype, device=audio.device)
        else:
            mask = melspec.example_valid_mask(valid_samples, s)[..., None]
        denom = torch.clamp(mask.sum(1), min=1.0)  # (B, 1)
        return [(tap.reshape(b, n, -1) * mask).sum(1) / denom for tap in taps]


@register_model("vggish")
class Vggish(LayerVggish):
    """Embedding-only variant (reference vggish.py:40-73): 128-d output."""

    output_dims = EMBED_DIM

    def forward(self, audio, valid_samples=None):
        return super().forward(audio, valid_samples)[-1]


def state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``{params}`` tree (nested numpy dicts) -> the
    torchvggish-named ``state_dict`` of ``LayerVggish``. The inverse of
    ``acav100m_tpu.models.vggish.convert_torch_state_dict``: conv kernels
    HWIO -> OIHW, dense kernels transposed."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for tk, fk in _CONV_KEYS:
        w = np.asarray(params[fk]["kernel"])  # (H, W, I, O)
        sd[f"{tk}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        sd[f"{tk}.bias"] = torch.from_numpy(np.asarray(params[fk]["bias"]))
    for tk, fk in _FC_KEYS:
        w = np.asarray(params[fk]["kernel"])  # (in, out)
        sd[f"{tk}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        sd[f"{tk}.bias"] = torch.from_numpy(np.asarray(params[fk]["bias"]))
    return sd


def convert_torch_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """A torch.hub VGGish state dict (numpy arrays) -> the JAX package's flax
    ``{params}`` tree, as ``acav100m_tpu.models.vggish.convert_torch_state_dict``
    makes it: conv kernels OIHW -> HWIO, dense kernels (out, in) -> (in, out)."""
    params = {}
    for tk, fk in _CONV_KEYS:
        params[fk] = {"kernel": np.asarray(sd[f"{tk}.weight"]).transpose(2, 3, 1, 0),
                      "bias": np.asarray(sd[f"{tk}.bias"])}
    for tk, fk in _FC_KEYS:
        params[fk] = {"kernel": np.asarray(sd[f"{tk}.weight"]).T,
                      "bias": np.asarray(sd[f"{tk}.bias"])}
    return {"params": params}
