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
Batch norm is ``BatchNorm``, ``nn.BatchNorm{1,2,3}d``'s semantics and
state-dict keys with momentum 0.1 and eps 1e-5: the JAX package's
``TorchBatchNorm`` exists to give flax exactly these semantics (unbiased
running variance, flax momentum 0.9).

``dtype`` is flax's ``dtype`` with float32 ``param_dtype``: parameters and
batch-norm buffers keep their dtype, each conv and dense layer casts its
input and weight to ``dtype``, batch norm computes in at least float32 and
returns ``dtype``, and the l2 normalisation and ``contrast_loss`` run in
it. None means the parameters' dtype.

Data parallelism (``set_group``): under the JAX package's ``jit`` with a
batch-sharded input, batch norm's statistics and the InfoNCE logits are
global. Here each rank of a ``runtime.Group`` holds its rows, so batch
norm in train mode sums its statistics over the ranks (``BatchNorm`` with
a group) and ``contrast_loss`` gathers the other ranks' embeddings, the
reference's SyncBN and ``diff_all_gather`` with rank-offset labels.

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
from ..runtime.mesh import Group, all_gather_rows, all_reduce_sum, sum_shares

PROJECTION_SIZE = 128
TEMPERATURE = 0.1
VISUAL_TEMP_KERNELS = [5, 1, 1, 3, 3]
STAGE_BLOCKS = [3, 4, 6, 3]
BN_MOMENTUM = 0.1  # torch convention: flax's 0.9 decay
BN_EPS = 1e-5


def _distributed(group: Optional[Group]) -> bool:
    return group is not None and group.distributed


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over every rank's rows of ``group``: the
    global mean, then the global biased variance from the sum of squared
    deviations from it (two passes, as the JAX package's ``TorchBatchNorm``
    computes them); the running variance takes the unbiased variance at the
    global count. The backward sums ``dy`` and ``dy * x_hat`` over the
    ranks for the input's gradient, and returns this rank's sums as the
    weight's and bias's gradients (the gradient all-reduce adds the
    ranks')."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, group):
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = [1, c] + [1] * (x.dim() - 2)
        sums = all_reduce_sum(torch.cat([x.sum(dims), x.new_full((1,), x.numel() // c)]),
                              group)
        count = sums[c]
        mean = sums[:c] / count
        xc = x - mean.view(shape)
        var = all_reduce_sum(xc.square().sum(dims), group) / count
        invstd = torch.rsqrt(var + eps)
        x_hat = xc * invstd.view(shape)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean.to(running_mean.dtype))
            unbiased = var * (count / (count - 1).clamp(min=1))
            running_var.mul_(1 - momentum).add_(momentum * unbiased.to(running_var.dtype))
        ctx.save_for_backward(x_hat, weight, invstd, count)
        ctx.group = group
        return x_hat * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        x_hat, weight, invstd, count = ctx.saved_tensors
        c = dy.shape[1]
        dims = [0, *range(2, dy.dim())]
        shape = [1, c] + [1] * (dy.dim() - 2)
        local = torch.cat([dy.sum(dims), (dy * x_hat).sum(dims)])
        sums = all_reduce_sum(local.clone(), ctx.group) / count
        dx = (dy - sums[:c].view(shape) - x_hat * sums[c:].view(shape)) \
            * (weight * invstd).view(shape)
        return dx, local[c:], local[:c], None, None, None, None, None


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """``nn.BatchNorm{1,2,3}d`` (their state-dict keys, momentum 0.1, eps
    1e-5) for ``ndim``-dimensional inputs, computing in at least float32
    and returning ``dtype`` (None: the weight's), as the JAX package's
    ``TorchBatchNorm``. ``group`` (``set_group``): in train mode the
    statistics are over every rank's rows of a distributed group."""

    def __init__(self, num_features: int, ndim: int, dtype=None):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.ndim = ndim
        self.compute_dtype = dtype
        self.group: Optional[Group] = None

    def _check_input_dim(self, x):
        if x.dim() != self.ndim:
            raise ValueError(f"expected a {self.ndim}-D input, got {x.dim()}-D")

    def forward(self, x):
        dtype = self.compute_dtype or self.weight.dtype
        xs = x.to(torch.promote_types(dtype, torch.float32))
        if not (self.training and _distributed(self.group)):
            return super().forward(xs).to(dtype)
        self._check_input_dim(xs)
        self.num_batches_tracked.add_(1)
        return _GroupBatchNorm.apply(xs, self.weight, self.bias, self.running_mean,
                                     self.running_var, self.momentum, self.eps,
                                     self.group).to(dtype)


def set_group(module: nn.Module, group: Optional[Group]) -> None:
    """Every ``BatchNorm`` of ``module`` computes its train-mode statistics
    over ``group``'s ranks (None: this process's rows alone)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class _CastConv:
    """A conv that casts its input and weight to ``compute_dtype`` (None:
    the weight's), flax's ``dtype``."""

    compute_dtype = None

    def forward(self, x):
        dtype = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), None)


class _Conv3d(_CastConv, nn.Conv3d):
    pass


class _Conv2d(_CastConv, nn.Conv2d):
    pass


class _Linear(nn.Linear):
    """``nn.Linear`` casting its input, weight and bias to ``compute_dtype``
    (None: the weight's)."""

    compute_dtype = None

    def forward(self, x):
        dtype = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


def _with_dtype(layer, dtype):
    layer.compute_dtype = dtype
    return layer


def _conv3d(cin: int, cout: int, kernel, stride=1, padding=0, dtype=None) -> nn.Conv3d:
    return _with_dtype(_Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                               bias=False), dtype)


def _conv2d(cin: int, cout: int, kernel, stride=1, padding=0, dtype=None) -> nn.Conv2d:
    return _with_dtype(_Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                               bias=False), dtype)


@contextlib.contextmanager
def _keep_running_stats(module: nn.Module):
    """Restores ``module``'s batch-norm buffers on exit: a rematerialized
    block's second forward must not update the running stats again (flax's
    ``nn.remat`` recomputes without side effects). Over a group the second
    forward issues the first's collectives again, on every rank alike."""
    saved = [(b, b.clone()) for m in module.modules() if isinstance(m, BatchNorm)
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
    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, kt: int, s: int, dtype):
        super().__init__()
        self.a = _conv3d(dim_in, dim_inner, (kt, 1, 1), padding=(kt // 2, 0, 0), dtype=dtype)
        self.a_bn = BatchNorm(dim_inner, 5, dtype)
        self.b = _conv3d(dim_inner, dim_inner, (1, 3, 3), stride=(1, s, s),
                         padding=(0, 1, 1), dtype=dtype)
        self.b_bn = BatchNorm(dim_inner, 5, dtype)
        self.c = _conv3d(dim_inner, dim_out, 1, dtype=dtype)
        self.c_bn = BatchNorm(dim_out, 5, dtype)

    def forward(self, x):
        h = F.relu(self.a_bn(self.a(x)))
        h = F.relu(self.b_bn(self.b(h)))
        return self.c_bn(self.c(h))


class Bottleneck3D(nn.Module):
    """(B, Cin, T, H, W) -> (B, dim_out, T, H/s, W/s); a projection
    shortcut (``branch1``) where the width or the stride changes."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int, temp_kernel: int,
                 spatial_stride: int = 1, dtype=None):
        super().__init__()
        s = spatial_stride
        if dim_in != dim_out or s != 1:
            self.branch1 = _conv3d(dim_in, dim_out, 1, stride=(1, s, s), dtype=dtype)
            self.branch1_bn = BatchNorm(dim_out, 5, dtype)
        self.branch2 = _Branch2Visual(dim_in, dim_inner, dim_out, temp_kernel, s, dtype)

    def forward(self, x):
        shortcut = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return F.relu(shortcut + self.branch2(x))


class _VisualStem(nn.Module):
    def __init__(self, width: int, dtype):
        super().__init__()
        kt = VISUAL_TEMP_KERNELS[0]
        self.conv = _conv3d(3, width, (kt, 7, 7), stride=(2, 2, 2), padding=(kt // 2, 3, 3),
                            dtype=dtype)
        self.bn = BatchNorm(width, 5, dtype)

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

    def __init__(self, width: int = 64, remat: bool = False, dtype=None):
        super().__init__()
        self.width = width
        self.remat = remat
        self.output_size = width * 32
        self.s1 = nn.Module()
        self.s1.pathway0_stem = _VisualStem(width, dtype)
        dims_out, dims_inner = _stage_dims(width)
        strides = [1, 2, 2, 2]
        dim_in = width
        for si in range(4):
            stage = nn.Module()
            for bi in range(STAGE_BLOCKS[si]):
                stage.add_module(f"pathway0_res{bi}", Bottleneck3D(
                    dim_in, dims_out[si], dims_inner[si], VISUAL_TEMP_KERNELS[si + 1],
                    strides[si] if bi == 0 else 1, dtype))
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
                 separable: bool, dtype):
        super().__init__()
        self.separable = separable
        self.a = _conv2d(dim_in, dim_inner, 1, dtype=dtype)
        self.a_bn = BatchNorm(dim_inner, 4, dtype)
        if separable:
            self.b1 = _conv2d(dim_inner, dim_inner, (3, 1), stride=(s, 1), padding=(1, 0),
                              dtype=dtype)
            self.b1_bn = BatchNorm(dim_inner, 4, dtype)
            self.b2 = _conv2d(dim_inner, dim_inner, (1, 3), stride=(1, s), padding=(0, 1),
                              dtype=dtype)
            self.b2_bn = BatchNorm(dim_inner, 4, dtype)
        else:
            self.b = _conv2d(dim_inner, dim_inner, 3, stride=s, padding=1, dtype=dtype)
            self.b_bn = BatchNorm(dim_inner, 4, dtype)
        self.c = _conv2d(dim_inner, dim_out, 1, dtype=dtype)
        self.c_bn = BatchNorm(dim_out, 4, dtype)

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
                 separable: bool = False, dtype=None):
        super().__init__()
        if dim_in != dim_out or stride != 1:
            self.branch1 = _conv2d(dim_in, dim_out, 1, stride=stride, dtype=dtype)
            self.branch1_bn = BatchNorm(dim_out, 4, dtype)
        self.branch2 = _Branch2Audio(dim_in, dim_inner, dim_out, stride, separable, dtype)

    def forward(self, x):
        shortcut = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return F.relu(shortcut + self.branch2(x))


class _AudioStem(nn.Module):
    def __init__(self, width: int, dtype):
        super().__init__()
        self.conv1 = _conv2d(1, width, (9, 1), padding=(4, 0), dtype=dtype)
        self.bn1 = BatchNorm(width, 4, dtype)
        self.conv2 = _conv2d(width, width, (1, 9), padding=(0, 4), dtype=dtype)
        self.bn2 = BatchNorm(width, 4, dtype)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class AudioResNet2D(nn.Module):
    """(B, 1, freq=80, time=128) log-mel -> (B, 32 * width), 1024 at the
    default width 32 (reference config.py:226)."""

    def __init__(self, width: int = 32, dtype=None):
        super().__init__()
        self.width = width
        self.output_size = width * 32
        self.s1 = nn.Module()
        self.s1.stem = _AudioStem(width, dtype)
        dims_out, dims_inner = _stage_dims(width)
        dim_in = width
        for si in range(4):
            stage = nn.Module()
            for bi in range(STAGE_BLOCKS[si]):
                stage.add_module(f"res{bi}", Bottleneck2D(
                    dim_in, dims_out[si], dims_inner[si], 2 if bi == 0 else 1,
                    separable=si < 2, dtype=dtype))  # s2/s3 separable, s4/s5 full
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

    def __init__(self, dim_in: int, hidden: int, out: int, dtype=None):
        super().__init__()
        self.fc1 = _with_dtype(_Linear(dim_in, hidden, bias=False), dtype)
        self.bn = BatchNorm(hidden, 2, dtype)
        self.fc2 = _with_dtype(_Linear(hidden, out), dtype)

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
    80, 128)) -> l2-normalized (B, 128) embeddings, each, in ``dtype``."""

    def __init__(self, projection_size: int = PROJECTION_SIZE, remat: bool = False,
                 visual_width: int = 64, audio_width: int = 32, dtype=None):
        super().__init__()
        self.visual_conv = VisualResNet3D(visual_width, remat=remat, dtype=dtype)
        self.audio_conv = AudioResNet2D(audio_width, dtype=dtype)
        dv, da = self.visual_conv.output_size, self.audio_conv.output_size
        self.visual_mlp = FFNLayer(dv, dv, projection_size, dtype)
        self.audio_mlp = FFNLayer(da, da, projection_size, dtype)

    def forward(self, visual, audio):
        zv = self.visual_mlp(self.visual_conv(visual))
        za = self.audio_mlp(self.audio_conv(audio))
        return F.normalize(zv, dim=-1, eps=1e-12), F.normalize(za, dim=-1, eps=1e-12)


def contrast_loss(zv: torch.Tensor, za: torch.Tensor, temperature: float = TEMPERATURE,
                  group: Optional[Group] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric cross-modal InfoNCE over the batch -> (loss, top-1
    accuracy in percent), in the embeddings' dtype.

    Over a distributed ``group`` the batch is every rank's rows: this
    rank's rows against the gathered embeddings of all ranks, labels
    offset by the rank's first row. The rank's loss is its rows' share of
    the global loss (its cross-entropies over the global 2B);
    ``sum_shares`` returns the global loss and accuracy on every rank and
    passes the gradient to the share unchanged, so that summing the
    parameters' gradients over the ranks gives the global loss's."""
    b = zv.shape[0]
    world, rank = (group.world_size, group.rank) if _distributed(group) else (1, 0)
    logits_ab = zv @ all_gather_rows(za, group).T / temperature
    logits_ba = za @ all_gather_rows(zv, group).T / temperature
    labels = torch.arange(b, device=zv.device) + rank * b
    loss = (F.cross_entropy(logits_ab, labels, reduction="sum")
            + F.cross_entropy(logits_ba, labels, reduction="sum")) / (2 * b * world)
    correct = ((logits_ab.argmax(-1) == labels).sum()
               + (logits_ba.argmax(-1) == labels).sum())
    if _distributed(group):
        total = sum_shares(torch.stack([loss.double(), correct.double()]), group)
        loss, correct = total[0].to(loss.dtype), total[1].detach().long()
    return loss, correct / (2 * b * world) * 100.0


class ClassifyHead(nn.Module):
    """Linear-eval head over frozen backbone features
    (models/classify.py:13-163): dropout, then ``projection`` in ``dtype``.

    ``forward(feats, mask)`` with a boolean keep ``mask`` of feats' shape
    applies that dropout mask in train mode (kept entries scaled by
    1 / (1 - rate), as flax's and torch's dropout do) instead of drawing
    one, so a caller can fix the draws."""

    def __init__(self, in_features: int, num_classes: int, dropout_rate: float = 0.5,
                 dtype=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.projection = _with_dtype(_Linear(in_features, num_classes), dtype)

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
