"""Evaluation-suite models: contrastive pretraining + linear eval heads.

The counterpart of ``acav100m_tpu/evaluation/models.py`` in PyTorch, NCDHW
and NCHW:

* ``VisualResNet3D`` — single-pathway 3D ResNet-50, width 64, temporal
  kernels [5,1,1,3,3] (stem + s2..s5), stem stride (2,2,2) so the
  temporal dim halves, stem max pool (1,3,3)/(1,2,2), spatial stage
  strides [1,2,2,2], global average pool -> 2048
  (reference ``evaluation/code/models/video_model_builder.py:30-265``);
* ``AudioResNet2D`` — 2D ResNet-50 on log-mel (freq 80 x time 128), width
  32: separable stem ((9,1) then (1,9) conv, each with BN + ReLU, no pool),
  stage strides [2,2,2,2], separable (3,1)+(1,3) "b" convs in s2/s3 and
  full (3,3) in s4/s5 -> 1024 (``models/audio_model_builder.py:15-221``);
* ``FFNLayer`` projection heads (fc1 without bias, BN + ReLU, fc2) and the
  symmetric InfoNCE ``contrast_loss`` with temperature 0.1
  (``models/utils.py:46-86``, ``models/contrast.py:80-148``);
* ``ClassifyHead`` — dropout and one linear layer over frozen backbone
  features (``models/classify.py:13-163``).

Modules carry the reference's torch names (``visual_conv.s1.pathway0_stem
.conv``, ``audio_conv.s2.res0.branch2.b1_bn``, ``visual_mlp.fc1``, the
head's ``projection``), the names ``convert_contrast_state_dict`` reads,
so the reference's checkpoints load with ``load_state_dict`` and the
weight-decay split by ``'bn' in name`` picks the reference's parameters.
Batch norm is ``nn.BatchNorm{1,2,3}d`` with momentum 0.1 and eps 1e-5: the
JAX package's ``TorchBatchNorm`` exists to give flax exactly these
semantics (unbiased running variance, flax momentum 0.9).

``state_dict_from_flax`` and ``flax_from_state_dict`` carry the JAX
package's ``{"params", "batch_stats"}`` trees (numpy) across, in both
directions; ``flax_from_state_dict`` is ``convert_contrast_state_dict``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models import init_weights

PROJECTION_SIZE = 128
TEMPERATURE = 0.1
VISUAL_TEMP_KERNELS = [5, 1, 1, 3, 3]
STAGE_BLOCKS = [3, 4, 6, 3]
BN_MOMENTUM = 0.1  # torch convention: flax's 0.9 decay
BN_EPS = 1e-5

_BN = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)


def _bn(cls, dim: int) -> nn.Module:
    return cls(dim, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv3d(cin: int, cout: int, kernel, stride=1, padding=0) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding, bias=False)


def _conv2d(cin: int, cout: int, kernel, stride=1, padding=0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)


@contextlib.contextmanager
def _keep_running_stats(module: nn.Module):
    """Restores ``module``'s batch-norm buffers on exit: a rematerialized
    block's second forward must not update the running stats again (flax's
    ``nn.remat`` recomputes without side effects)."""
    saved = [(b, b.clone()) for m in module.modules() if isinstance(m, _BN)
             for b in (m.running_mean, m.running_var, m.num_batches_tracked)]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


def _run_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    if not (remat and torch.is_grad_enabled() and x.requires_grad):
        return block(x)
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _keep_running_stats(block)))


class _Branch2Visual(nn.Module):
    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, kt: int, s: int):
        super().__init__()
        self.a = _conv3d(dim_in, dim_inner, (kt, 1, 1), padding=(kt // 2, 0, 0))
        self.a_bn = _bn(nn.BatchNorm3d, dim_inner)
        self.b = _conv3d(dim_inner, dim_inner, (1, 3, 3), stride=(1, s, s),
                         padding=(0, 1, 1))
        self.b_bn = _bn(nn.BatchNorm3d, dim_inner)
        self.c = _conv3d(dim_inner, dim_out, 1)
        self.c_bn = _bn(nn.BatchNorm3d, dim_out)

    def forward(self, x):
        h = F.relu(self.a_bn(self.a(x)))
        h = F.relu(self.b_bn(self.b(h)))
        return self.c_bn(self.c(h))


class Bottleneck3D(nn.Module):
    """(B, Cin, T, H, W) -> (B, dim_out, T, H/s, W/s); a projection
    shortcut (``branch1``) where the width or the stride changes."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int, temp_kernel: int,
                 spatial_stride: int = 1):
        super().__init__()
        s = spatial_stride
        if dim_in != dim_out or s != 1:
            self.branch1 = _conv3d(dim_in, dim_out, 1, stride=(1, s, s))
            self.branch1_bn = _bn(nn.BatchNorm3d, dim_out)
        self.branch2 = _Branch2Visual(dim_in, dim_inner, dim_out, temp_kernel, s)

    def forward(self, x):
        shortcut = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return F.relu(shortcut + self.branch2(x))


class _VisualStem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        kt = VISUAL_TEMP_KERNELS[0]
        self.conv = _conv3d(3, width, (kt, 7, 7), stride=(2, 2, 2), padding=(kt // 2, 3, 3))
        self.bn = _bn(nn.BatchNorm3d, width)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _stage_dims(width: int):
    """(dims_out, dims_inner) of stages s2..s5."""
    return ([width * 4, width * 8, width * 16, width * 32],
            [width, width * 2, width * 4, width * 8])


class VisualResNet3D(nn.Module):
    """(B, 3, T, H, W) normalized frames -> (B, 32 * width), 2048 at the
    default width.

    ``remat=True`` recomputes each bottleneck block on the backward pass
    (``torch.utils.checkpoint``), keeping only the blocks' inputs alive."""

    def __init__(self, width: int = 64, remat: bool = False):
        super().__init__()
        self.width = width
        self.remat = remat
        self.output_size = width * 32
        self.s1 = nn.Module()
        self.s1.pathway0_stem = _VisualStem(width)
        dims_out, dims_inner = _stage_dims(width)
        strides = [1, 2, 2, 2]
        dim_in = width
        for si in range(4):
            stage = nn.Module()
            for bi in range(STAGE_BLOCKS[si]):
                stage.add_module(f"pathway0_res{bi}", Bottleneck3D(
                    dim_in, dims_out[si], dims_inner[si], VISUAL_TEMP_KERNELS[si + 1],
                    strides[si] if bi == 0 else 1))
                dim_in = dims_out[si]
            self.add_module(f"s{si + 2}", stage)

    def blocks(self) -> List[nn.Module]:
        return [b for si in range(4) for b in getattr(self, f"s{si + 2}").children()]

    def forward(self, x):
        x = self.s1.pathway0_stem(x)
        x = F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        for block in self.blocks():
            x = _run_block(block, x, self.remat)
        return x.mean(dim=(2, 3, 4))


class _Branch2Audio(nn.Module):
    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, s: int,
                 separable: bool):
        super().__init__()
        self.separable = separable
        self.a = _conv2d(dim_in, dim_inner, 1)
        self.a_bn = _bn(nn.BatchNorm2d, dim_inner)
        if separable:
            self.b1 = _conv2d(dim_inner, dim_inner, (3, 1), stride=(s, 1), padding=(1, 0))
            self.b1_bn = _bn(nn.BatchNorm2d, dim_inner)
            self.b2 = _conv2d(dim_inner, dim_inner, (1, 3), stride=(1, s), padding=(0, 1))
            self.b2_bn = _bn(nn.BatchNorm2d, dim_inner)
        else:
            self.b = _conv2d(dim_inner, dim_inner, 3, stride=s, padding=1)
            self.b_bn = _bn(nn.BatchNorm2d, dim_inner)
        self.c = _conv2d(dim_inner, dim_out, 1)
        self.c_bn = _bn(nn.BatchNorm2d, dim_out)

    def forward(self, x):
        h = F.relu(self.a_bn(self.a(x)))
        if self.separable:
            h = F.relu(self.b1_bn(self.b1(h)))
            h = F.relu(self.b2_bn(self.b2(h)))
        else:
            h = F.relu(self.b_bn(self.b(h)))
        return self.c_bn(self.c(h))


class Bottleneck2D(nn.Module):
    """Audio bottleneck (reference ``audio_resnet_helper.py:139-291``):
    ``separable`` splits the 3x3 "b" conv into (3,1) freq and (1,3) time
    convs, each followed by BN + ReLU."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int, stride: int = 1,
                 separable: bool = False):
        super().__init__()
        if dim_in != dim_out or stride != 1:
            self.branch1 = _conv2d(dim_in, dim_out, 1, stride=stride)
            self.branch1_bn = _bn(nn.BatchNorm2d, dim_out)
        self.branch2 = _Branch2Audio(dim_in, dim_inner, dim_out, stride, separable)

    def forward(self, x):
        shortcut = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return F.relu(shortcut + self.branch2(x))


class _AudioStem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv1 = _conv2d(1, width, (9, 1), padding=(4, 0))
        self.bn1 = _bn(nn.BatchNorm2d, width)
        self.conv2 = _conv2d(width, width, (1, 9), padding=(0, 4))
        self.bn2 = _bn(nn.BatchNorm2d, width)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class AudioResNet2D(nn.Module):
    """(B, 1, freq=80, time=128) log-mel -> (B, 32 * width), 1024 at the
    default width 32 (reference config.py:226)."""

    def __init__(self, width: int = 32):
        super().__init__()
        self.width = width
        self.output_size = width * 32
        self.s1 = nn.Module()
        self.s1.stem = _AudioStem(width)
        dims_out, dims_inner = _stage_dims(width)
        dim_in = width
        for si in range(4):
            stage = nn.Module()
            for bi in range(STAGE_BLOCKS[si]):
                stage.add_module(f"res{bi}", Bottleneck2D(
                    dim_in, dims_out[si], dims_inner[si], 2 if bi == 0 else 1,
                    separable=si < 2))  # s2/s3 separable, s4/s5 full
                dim_in = dims_out[si]
            self.add_module(f"s{si + 2}", stage)

    def forward(self, x):
        x = self.s1.stem(x)
        for si in range(4):
            for block in getattr(self, f"s{si + 2}").children():
                x = block(x)
        return x.mean(dim=(2, 3))


class FFNLayer(nn.Module):
    """in -> hidden (BN + ReLU) -> out projection (models/utils.py:46-86);
    fc1 carries no bias, fc2 does."""

    def __init__(self, dim_in: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden, bias=False)
        self.bn = _bn(nn.BatchNorm1d, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.bn(self.fc1(x))))


def init_eval_weights(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init from ``generator``: lecun-normal kernels, zero
    biases, BN weight 1 and bias 0 (torch's defaults), and each block's
    ``c_bn`` weight 0, the JAX package's ``scale_init=zeros``
    (``acav100m_tpu/evaluation/models.py:132-134``)."""
    init_weights(module, generator)
    with torch.no_grad():
        for name, mod in module.named_modules():
            if name.endswith("c_bn"):
                mod.weight.zero_()


class Contrast(nn.Module):
    """Audio-visual contrastive model: (visual (B, 3, T, H, W), audio (B, 1,
    80, 128)) -> l2-normalized (B, 128) embeddings, each."""

    def __init__(self, projection_size: int = PROJECTION_SIZE, remat: bool = False,
                 visual_width: int = 64, audio_width: int = 32):
        super().__init__()
        self.visual_conv = VisualResNet3D(visual_width, remat=remat)
        self.audio_conv = AudioResNet2D(audio_width)
        dv, da = self.visual_conv.output_size, self.audio_conv.output_size
        self.visual_mlp = FFNLayer(dv, dv, projection_size)
        self.audio_mlp = FFNLayer(da, da, projection_size)

    def forward(self, visual, audio):
        zv = self.visual_mlp(self.visual_conv(visual))
        za = self.audio_mlp(self.audio_conv(audio))
        return F.normalize(zv, dim=-1, eps=1e-12), F.normalize(za, dim=-1, eps=1e-12)


def contrast_loss(zv: torch.Tensor, za: torch.Tensor,
                  temperature: float = TEMPERATURE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric cross-modal InfoNCE over the batch -> (loss, top-1
    accuracy in percent)."""
    b = zv.shape[0]
    logits_ab = zv @ za.T / temperature
    logits_ba = za @ zv.T / temperature
    labels = torch.arange(b, device=zv.device)
    loss = (F.cross_entropy(logits_ab, labels, reduction="sum")
            + F.cross_entropy(logits_ba, labels, reduction="sum")) / (2 * b)
    correct = ((logits_ab.argmax(-1) == labels).sum()
               + (logits_ba.argmax(-1) == labels).sum())
    return loss, correct / (2 * b) * 100.0


class ClassifyHead(nn.Module):
    """Linear-eval head over frozen backbone features
    (models/classify.py:13-163): dropout, then ``projection``.

    ``forward(feats, mask)`` with a boolean keep ``mask`` of feats' shape
    applies that dropout mask in train mode (kept entries scaled by
    1 / (1 - rate), as flax's and torch's dropout do) instead of drawing
    one, so a caller can fix the draws."""

    def __init__(self, in_features: int, num_classes: int, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.projection = nn.Linear(in_features, num_classes)

    def forward(self, feats, mask: Optional[torch.Tensor] = None):
        if not self.training or self.dropout_rate == 0:
            h = feats
        elif mask is None:
            h = F.dropout(feats, self.dropout_rate, training=True)
        else:
            h = torch.where(mask, feats / (1.0 - self.dropout_rate), 0.0)
        return self.projection(h)


# -- carrying the JAX package's variables -------------------------------------------

def _backbone_pairs(visual: bool) -> List[Tuple[str, Tuple, bool]]:
    """(torch module name, flax path, is a conv) of each weighted layer of
    one backbone. A stage's first block is the only one with a projection
    shortcut (``branch1``), at any width."""
    out: List[Tuple[str, Tuple, bool]] = []
    if visual:
        out += [("s1.pathway0_stem.conv", ("stem_conv",), True),
                ("s1.pathway0_stem.bn", ("stem_bn",), False)]
    else:
        for j in (1, 2):
            out += [(f"s1.stem.conv{j}", (f"stem_conv{j}",), True),
                    (f"s1.stem.bn{j}", (f"stem_bn{j}",), False)]
    for si, nblocks in enumerate(STAGE_BLOCKS):
        for bi in range(nblocks):
            tmod = f"s{si + 2}.pathway0_res{bi}" if visual else f"s{si + 2}.res{bi}"
            fmod = f"s{si + 2}_b{bi}"
            if bi == 0:
                out += [(f"{tmod}.branch1", (fmod, "branch1"), True),
                        (f"{tmod}.branch1_bn", (fmod, "branch1_bn"), False)]
            names = ("a", "b", "c") if (visual or si >= 2) else ("a", "b1", "b2", "c")
            for n in names:
                out += [(f"{tmod}.branch2.{n}", (fmod, n), True),
                        (f"{tmod}.branch2.{n}_bn", (fmod, f"{n}_bn"), False)]
    return out


def _ffn_pairs() -> List[Tuple[str, Tuple, bool]]:
    return [("fc1", ("fc1",), True), ("bn", ("bn",), False), ("fc2", ("fc2",), True)]


def _pairs() -> List[Tuple[str, Tuple, bool]]:
    """(module, flax path, is a conv or dense) of every layer of
    ``Contrast``, module names and flax paths prefixed by the submodule."""
    out = []
    for name, visual in (("visual_conv", True), ("audio_conv", False)):
        out += [(f"{name}.{t}", (name, *p), c) for t, p, c in _backbone_pairs(visual)]
    for name in ("visual_mlp", "audio_mlp"):
        out += [(f"{name}.{t}", (name, *p), c) for t, p, c in _ffn_pairs()]
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _put(tree: Dict, path, leaf) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def _tensor(arr) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, np.float32))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}  # DHWIO, HWIO, (in, out)
_TO_FLAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _kernel_to_torch(k) -> np.ndarray:
    """flax kernel -> torch weight: DHWIO -> OIDHW, HWIO -> OIHW, (in, out)
    -> (out, in)."""
    k = np.asarray(k)
    return k.transpose(_TO_TORCH[k.ndim])


def _kernel_to_flax(w) -> np.ndarray:
    """torch weight -> flax kernel, the inverse of ``_kernel_to_torch``."""
    w = np.asarray(w)
    return w.transpose(_TO_FLAX[w.ndim])


def _from_flax(pairs, variables: Dict) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for tkey, path, is_conv in pairs:
        node = _get(params, path)
        if is_conv:
            sd[f"{tkey}.weight"] = _tensor(_kernel_to_torch(node["kernel"]))
            if "bias" in node:
                sd[f"{tkey}.bias"] = _tensor(node["bias"])
            continue
        st = _get(stats, path)
        sd[f"{tkey}.weight"] = _tensor(node["scale"])
        sd[f"{tkey}.bias"] = _tensor(node["bias"])
        sd[f"{tkey}.running_mean"] = _tensor(st["mean"])
        sd[f"{tkey}.running_var"] = _tensor(st["var"])
        sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _to_flax(pairs, sd: Dict) -> Dict:
    params: Dict = {}
    stats: Dict = {}
    for tkey, path, is_conv in pairs:
        if f"{tkey}.weight" not in sd:  # a submodule the state dict lacks
            continue
        if is_conv:
            leaf = {"kernel": _kernel_to_flax(_numpy(sd[f"{tkey}.weight"]))}
            if f"{tkey}.bias" in sd:
                leaf["bias"] = _numpy(sd[f"{tkey}.bias"])
            _put(params, path, leaf)
            continue
        _put(params, path, {"scale": _numpy(sd[f"{tkey}.weight"]),
                            "bias": _numpy(sd[f"{tkey}.bias"])})
        _put(stats, path, {"mean": _numpy(sd[f"{tkey}.running_mean"]),
                           "var": _numpy(sd[f"{tkey}.running_var"])})
    return {"params": params, "batch_stats": stats}


def state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Contrast`` variables (``{"params",
    "batch_stats"}`` trees of numpy arrays) -> ``Contrast``'s state dict;
    the exact inverse of ``convert_contrast_state_dict``. A tree holding
    only some of the submodules (``strip_heads``' backbones) gives those."""
    return _from_flax([p for p in _pairs() if p[1][0] in variables["params"]], variables)


def flax_from_state_dict(sd: Dict) -> Dict:
    """``Contrast``'s state dict (tensors or numpy) -> the JAX package's
    ``{"params", "batch_stats"}`` tree of numpy arrays, as
    ``convert_contrast_state_dict`` makes it from the reference's state
    dict. Submodules absent from ``sd`` are left out."""
    return _to_flax(_pairs(), sd)


def backbone_state_dict_from_flax(variables: Dict, name: str) -> Dict[str, torch.Tensor]:
    """One backbone (``visual_conv`` or ``audio_conv``) of a ``Contrast``
    tree -> the state dict of a ``VisualResNet3D`` / ``AudioResNet2D``."""
    return _from_flax([(t, (name, *p), c) for t, p, c in
                       _backbone_pairs(name == "visual_conv")], variables)


def head_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ClassifyHead`` params -> ``ClassifyHead``'s state
    dict; the inverse of ``convert_classify_head_state_dict(sd, prefix="")``."""
    return _from_flax([("projection", ("proj",), True)], variables)


def head_flax_from_state_dict(sd: Dict) -> Dict:
    """``ClassifyHead``'s state dict -> the JAX package's ``{"params":
    {"proj": ...}}``."""
    return {"params": _to_flax([("projection", ("proj",), True)], sd)["params"]}


def strip_heads(contrast_variables: Dict) -> Dict:
    """Checkpoint surgery for linear eval: keep backbone variables only
    (reference utils/checkpoint.py load_pretrained_checkpoint:25-45)."""
    out: Dict = {}
    for col, tree in contrast_variables.items():
        out[col] = {k: v for k, v in tree.items() if k in ("visual_conv", "audio_conv")}
    return out
