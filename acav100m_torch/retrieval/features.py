"""Image/audio feature extractors for correspondence-retrieval experiments.

Counterpart of ``acav100m_tpu/retrieval/features.py``, the rebuild of the
reference's real-data pair pipeline:

* ResNet-50 layer-tap feature extractor with a chunked pkl feature cache
  (``correspondence_retrieval/code/model.py:137-222`` taps layer1..layer4 of
  a torchvision ResNet-50; ``feature.py:13-98`` extracts in chunks and
  caches each chunk as a pkl, resuming from existing chunk files). The
  chunk files are the JAX package's, so either package reads the other's.
* MNIST-sound-style audio pair features (``image_pair_data.py`` pairs MNIST
  digits with FSDD spoken-digit recordings; FSDD is not downloaded, so
  ``synthesize_spoken_digits`` generates 8 kHz digit-conditioned audio with
  the same shape/protocol and features come from the stage-4 log-mel front
  end, ``ops/melspec.py``).

The backbone is an ``nn.Module`` in NCHW with torchvision's module names,
so a torchvision ``resnet50`` state dict loads as it is once ``fc.*`` is
dropped; ``state_dict_from_flax`` carries the JAX package's variables
across. Its convolutions are ``nn.Conv2d`` (cuDNN on the card). Real
ImageNet weights are not in the repository: ``convert_torchvision_resnet50``
loads them when available; seeded random-init taps otherwise (random-
projection features, same architecture and protocol).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models import init_weights

RESNET50_BLOCKS = [3, 4, 6, 3]
LAYER_DIMS = [256, 512, 1024, 2048]


class Bottleneck(nn.Module):
    """torchvision's ``Bottleneck`` (stride on ``conv2``), BN eps 1e-5."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(dim_in, dim_inner, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(dim_inner, eps=1e-5)
        self.conv2 = nn.Conv2d(dim_inner, dim_inner, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(dim_inner, eps=1e-5)
        self.conv3 = nn.Conv2d(dim_inner, dim_out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(dim_out, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if dim_in != dim_out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(dim_in, dim_out, 1, stride, bias=False),
                nn.BatchNorm2d(dim_out, eps=1e-5))

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.relu(shortcut + h)


class ResNet50Features(nn.Module):
    """2D ResNet-50 with layer taps (torchvision topology and names, NCHW).

    Returns spatially mean-pooled features after layer1..layer4 — dims
    [256, 512, 1024, 2048] (reference model.py:137-222 taps the same
    modules and pools). Use it in eval mode: BN runs on its running
    statistics, as the JAX module's ``use_running_average=True``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        dim_in = 64
        for li, nblocks in enumerate(RESNET50_BLOCKS):
            dim_out = 256 * (2 ** li)
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                blocks.append(Bottleneck(dim_in, dim_out, dim_out // 4, stride))
                dim_in = dim_out
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        taps = []
        for li in range(len(RESNET50_BLOCKS)):
            x = getattr(self, f"layer{li + 1}")(x)
            taps.append(x.mean(dim=(2, 3)))
        return taps


def _module_pairs():
    """(torchvision conv or BN name, flax path) of every layer with weights."""
    pairs = [("conv1", ("conv1",)), ("bn1", ("bn1", "BatchNorm_0"))]
    for li, nblocks in enumerate(RESNET50_BLOCKS):
        for bi in range(nblocks):
            mod, tmod = f"layer{li + 1}_{bi}", f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                pairs.append((f"{tmod}.conv{ci}", (mod, f"conv{ci}")))
                pairs.append((f"{tmod}.bn{ci}", (mod, f"bn{ci}", "BatchNorm_0")))
            if bi == 0:  # every layer's first block has a projection
                pairs.append((f"{tmod}.downsample.0", (mod, "downsample")))
                pairs.append((f"{tmod}.downsample.1", (mod, "downsample_bn", "BatchNorm_0")))
    return pairs


def state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ResNet50Features`` variables (``params`` and
    ``batch_stats`` trees of arrays) -> this module's state dict. Conv HWIO
    -> OIHW; BN scale/bias and mean/var -> weight/bias and running stats."""

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for name, path in _module_pairs():
        if path[-1] != "BatchNorm_0":
            sd[f"{name}.weight"] = t(get(variables["params"], path)["kernel"]).permute(
                3, 2, 0, 1).contiguous()
            continue
        params, stats = get(variables["params"], path), get(variables["batch_stats"], path)
        sd[f"{name}.weight"] = t(params["scale"])
        sd[f"{name}.bias"] = t(params["bias"])
        sd[f"{name}.running_mean"] = t(stats["mean"])
        sd[f"{name}.running_var"] = t(stats["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd


def convert_torchvision_resnet50(sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision resnet50 state dict (tensors or numpy values) -> this
    module's state dict: the same names, the classifier ``fc.*`` dropped
    (taps only), float32 tensors, and ``num_batches_tracked`` where the
    source lacks it."""
    out: Dict[str, torch.Tensor] = {}
    for name, path in _module_pairs():
        keys = ["weight"]
        if path[-1] == "BatchNorm_0":
            keys += ["bias", "running_mean", "running_var"]
            tracked = sd.get(f"{name}.num_batches_tracked", 0)
            out[f"{name}.num_batches_tracked"] = torch.as_tensor(
                np.asarray(tracked), dtype=torch.int64)
        for key in keys:
            out[f"{name}.{key}"] = torch.as_tensor(
                np.asarray(sd[f"{name}.{key}"], np.float32))
    return out


# -- chunked feature extraction cache (reference feature.py:13-98) -------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ImageFeatureExtractor:
    """Batched ResNet-50 tap extraction with a chunked pkl cache, on
    ``device`` (default ``cuda``).

    ``extract(images)`` returns {layer_i: (N, dim)}. With ``cache_dir``
    set, features are computed chunk-by-chunk and each chunk is cached as
    ``feature_chunk_{i:04d}.pkl`` (a list of four float32 arrays, the JAX
    package's format); existing chunk files are loaded instead of
    recomputed (the reference's load-or-extract loop, feature.py:36-70).

    Weights: ``variables`` (the JAX package's flax trees), else a seeded
    init with flax's defaults (lecun-normal kernels; BN scale 1, bias 0,
    mean 0, var 1) from a CPU ``torch.Generator``, the same on every
    device. A torchvision state dict loads into ``model`` through
    ``convert_torchvision_resnet50``."""

    def __init__(self, variables: Optional[Dict] = None, size: int = 32,
                 chunk_size: int = 256, cache_dir=None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = ResNet50Features()
        self.size = size
        self.chunk_size = int(chunk_size)
        self.cache_dir = Path(cache_dir) if cache_dir is not None else None
        if variables is not None:
            self.model.load_state_dict(state_dict_from_flax(variables))
        else:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    def _prep(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, np.float32)
        if images.ndim == 3:  # grayscale -> RGB
            images = np.repeat(images[..., None], 3, axis=-1)
        if images.max() > 2.0:
            images = images / 255.0
        return (images - IMAGENET_MEAN) / IMAGENET_STD

    @torch.inference_mode()
    def _extract_chunk(self, chunk: np.ndarray) -> List[np.ndarray]:
        x = torch.as_tensor(self._prep(chunk), device=self.device).permute(0, 3, 1, 2)
        return [t.float().cpu().numpy() for t in self.model(x.contiguous())]

    def extract(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        chunks: List[List[np.ndarray]] = []
        for ci, start in enumerate(range(0, len(images), self.chunk_size)):
            cache = (
                self.cache_dir / f"feature_chunk_{ci:04d}.pkl"
                if self.cache_dir is not None else None
            )
            if cache is not None and cache.is_file():
                with open(cache, "rb") as f:
                    taps = pickle.load(f)
            else:
                taps = self._extract_chunk(images[start : start + self.chunk_size])
                if cache is not None:
                    cache.parent.mkdir(parents=True, exist_ok=True)
                    with open(cache, "wb") as f:
                        pickle.dump(taps, f)
            chunks.append(taps)
        num_layers = len(chunks[0])
        return {
            f"layer_{l}": np.concatenate([c[l] for c in chunks])
            for l in range(num_layers)
        }


# -- image pair views through the backbone --------------------------------------

def resnet_pair_views(
    images: np.ndarray,
    labels: np.ndarray,
    transform: str = "rotate",
    layers: Sequence[int] = (2, 3),
    extractor: Optional[ImageFeatureExtractor] = None,
    cache_dir=None,
    device=None,
) -> Dict[str, Dict[str, Dict]]:
    """(original, transformed) image pairs featurized by the ResNet taps —
    the reference's CIFAR10/MNIST rotated/flipped experiments
    (image_pair_data.py:26-204) with the model of model.py:137-222."""
    if transform == "rotate":
        transformed = np.rot90(images, k=1, axes=(1, 2))
    elif transform == "flip":
        transformed = np.ascontiguousarray(images[:, :, ::-1])
    else:
        raise ValueError(f"unknown transform {transform!r}")
    views: Dict[str, Dict[str, Dict]] = {}
    for mod, data in (("orig", images), (transform, transformed)):
        sub_cache = Path(cache_dir) / mod if cache_dir is not None else None
        ext = extractor or ImageFeatureExtractor(
            size=images.shape[1], cache_dir=sub_cache, device=device
        )
        if extractor is not None and sub_cache is not None:
            ext.cache_dir = sub_cache
        feats = ext.extract(data)
        for l in layers:
            arr = feats[f"layer_{l}"]
            views[f"{mod}-layer_{l}"] = {
                f"i{i:05d}": {"data": arr[i], "label": int(labels[i])}
                for i in range(len(arr))
            }
    return views


# -- MNIST-sound-style audio pairs ----------------------------------------------

def synthesize_spoken_digits(
    labels: np.ndarray, sr: int = 8000, duration: float = 0.5, seed: int = 0
) -> np.ndarray:
    """FSDD-shaped synthetic audio: one 8 kHz clip per item whose spectral
    content is digit-conditioned (two formant-style tones + digit-paced
    amplitude modulation + noise). Stands in for FSDD (reference
    MNIST-sound pairs, image_pair_data.py)."""
    rng = np.random.RandomState(seed)
    n = int(sr * duration)
    t = np.arange(n) / sr
    out = np.zeros((len(labels), n), np.float32)
    for i, y in enumerate(np.asarray(labels, int)):
        f1 = 300.0 + 150.0 * y + rng.randn() * 10.0
        f2 = 900.0 + 230.0 * y + rng.randn() * 20.0
        am = 2.0 + 0.7 * y
        sig = (
            np.sin(2 * np.pi * f1 * t)
            + 0.6 * np.sin(2 * np.pi * f2 * t)
        ) * (0.6 + 0.4 * np.sin(2 * np.pi * am * t))
        out[i] = (sig + 0.1 * rng.randn(n)).astype(np.float32)
    return out


def audio_logmel_features(audio: np.ndarray, sr: int = 8000,
                          num_bands: int = 32, device=None) -> np.ndarray:
    """(N, samples) -> (N, num_bands) time-pooled log-mel features via the
    stage-4 log-mel front end (ops/melspec.py), on ``device``."""
    from ..ops.melspec import log_mel_spectrogram

    device = resolve_device(device)
    feats = []
    for i in range(0, len(audio), 256):
        chunk = torch.as_tensor(np.asarray(audio[i : i + 256], np.float32), device=device)
        lm = log_mel_spectrogram(
            chunk, audio_sample_rate=sr, num_mel_bins=num_bands,
            upper_edge_hertz=min(3800.0, sr / 2 - 100.0),
        )  # (B, frames, bands)
        feats.append(lm.mean(dim=1).float().cpu().numpy())
    return np.concatenate(feats)


def mnist_sound_pair_views(
    images: np.ndarray,
    labels: np.ndarray,
    image_layers: Sequence[int] = (0, 1, 2, 3),
    extractor: Optional[ImageFeatureExtractor] = None,
    sr: int = 8000,
    seed: int = 0,
    device=None,
) -> Dict[str, Dict[str, Dict]]:
    """Image/audio pair views: digit images featurized by the ResNet taps,
    digit audio by log-mel — the reference's MNIST + FSDD experiment.

    All four ResNet taps by default (the reference runs its experiments
    with ``extract_each_layer: true``, search_targets/default.json): the
    bipartite pairing then scores 4 visual x audio cluster pairs — with a
    single pair, even perfect class-aligned clusterings leave the matched
    set barely separable (class-level derangement keeps deranged samples
    in coherent contingency cells; multiple pairs accumulate the
    diagonal-majority evidence)."""
    ext = extractor or ImageFeatureExtractor(size=images.shape[1], device=device)
    img_feats = ext.extract(images)
    audio = synthesize_spoken_digits(labels, sr=sr, seed=seed)
    aud_feats = audio_logmel_features(audio, sr=sr, device=ext.device)
    views: Dict[str, Dict[str, Dict]] = {}
    for l in image_layers:
        arr = img_feats[f"layer_{l}"]
        views[f"visual-layer_{l}"] = {
            f"i{i:05d}": {"data": arr[i], "label": int(labels[i])}
            for i in range(len(arr))
        }
    views["audio-layer_0"] = {
        f"i{i:05d}": {"data": aud_feats[i], "label": int(labels[i])}
        for i in range(len(aud_feats))
    }
    return views


def views_for_data_name(
    data_name: str,
    seed: int = 0,
    nclasses: int = 10,
    per_class: int = 50,
    size: int = 32,
    cache_dir=None,
    device=None,
) -> Dict[str, Dict[str, Dict]]:
    """Reference grid ``data_name`` -> pair views over the stand-in data
    (``image_pair_data.py:133-143`` name table; real CIFAR10/MNIST/FSDD are
    not downloaded):

    * ``image_pair_mnist``   (cifar10 x mnist): two independent image
      syntheses of the same label sequence, paired by index;
    * ``image_pair_rotation``/``image_pair_flip``: image + transformed copy;
    * ``image_pair_mnist_sound`` (mnist x fdss): images + spoken-digit audio.

    All four ResNet taps per image view (``extract_each_layer: true``).
    Default scale (10 classes x 50/class) keeps the reference grids'
    B=100/k=25 batch selection meaningful. ``cache_dir`` (or
    $ACAV_RETRIEVAL_CACHE) shares the ResNet feature cache across grid jobs
    with the same (data_name, seed).
    """
    import os

    data_name = data_name.lower()
    if cache_dir is None and os.environ.get("ACAV_RETRIEVAL_CACHE"):
        cache_dir = os.environ["ACAV_RETRIEVAL_CACHE"]
    if cache_dir is not None:
        cache_dir = Path(cache_dir) / f"{data_name}_s{seed}"
    images, labels = synthetic_digits(nclasses, per_class, size, seed=seed + 6)
    layers = (0, 1, 2, 3)
    if data_name in ("image_pair_rotation", "image_pair_flip"):
        return resnet_pair_views(
            images, labels,
            transform="rotate" if data_name == "image_pair_rotation" else "flip",
            layers=layers, cache_dir=cache_dir, device=device,
        )
    if data_name == "image_pair_mnist":
        images2, labels2 = synthetic_digits(nclasses, per_class, size,
                                            seed=seed + 106)
        assert (labels == labels2).all()
        views: Dict[str, Dict[str, Dict]] = {}
        for mod, data in (("viewA", images), ("viewB", images2)):
            ext = ImageFeatureExtractor(
                size=size,
                cache_dir=Path(cache_dir) / mod if cache_dir else None,
                device=device,
            )
            feats = ext.extract(data)
            for l in layers:
                arr = feats[f"layer_{l}"]
                views[f"{mod}-layer_{l}"] = {
                    f"i{i:05d}": {"data": arr[i], "label": int(labels[i])}
                    for i in range(len(arr))
                }
        return views
    if data_name == "image_pair_mnist_sound":
        ext = ImageFeatureExtractor(
            size=size, cache_dir=Path(cache_dir) / "img" if cache_dir else None,
            device=device,
        )
        return mnist_sound_pair_views(images, labels, image_layers=layers,
                                      extractor=ext, seed=seed)
    raise ValueError(f"no stand-in data for data_name {data_name!r}")


def synthetic_digits(
    nclasses: int = 10, per_class: int = 20, size: int = 32, seed: int = 0
):
    """Stand-in for MNIST/CIFAR arrays (not downloaded): class-distinctive
    structured images (oriented bars + class texture). Loaders accept any
    (N,H,W[,3]) uint8 array in their place."""
    rng = np.random.RandomState(seed)
    n = nclasses * per_class
    images = np.zeros((n, size, size, 3), np.uint8)
    labels = np.zeros(n, np.int64)
    idx = 0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(nclasses):
        angle = np.pi * c / nclasses
        stripes = np.sin(
            2 * np.pi * (np.cos(angle) * xx + np.sin(angle) * yy) * (2 + c % 3)
        )
        for _ in range(per_class):
            img = 127 + 100 * stripes + 20 * rng.randn(size, size)
            base = np.clip(img, 0, 255).astype(np.uint8)
            images[idx] = np.stack(
                [base, np.roll(base, c, axis=0), np.roll(base, c, axis=1)], -1
            )
            labels[idx] = c
            idx += 1
    return images, labels
