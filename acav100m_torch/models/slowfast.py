"""SlowFast 8x8 R50 video feature extractor (PyTorch).

Port of the canonical graph of ``acav100m_tpu/models/slowfast.py``
(reference ``feature_extraction/code/models/slowfast.py:31-157``, config
``Kinetics/c2/SLOWFAST_8x8_R50``), with PySlowFast's parameter names
(``s1.pathway0_stem.conv.weight``, ``s2.pathway0_res0.branch2.a.weight``,
``s1_fuse.conv_f2s.weight``, ...):

* slow pathway: T/4 frames, channels 64/256/512/1024/2048, temporal
  kernels [1,1,1,3,3] (stem + 4 stages);
* fast pathway: T frames, channels 8/32/64/128/256, temporal kernels
  [5,3,3,3,3];
* FuseFastToSlow after s1..s4: 7x1x1 conv, temporal stride 4, ratio 2;
* bottleneck blocks [3,4,6,3]; spatial strides [1,2,2,2]; the temporal
  kernel sits on the first 1x1x1 conv; inference batch norm.

``LayerSlowFast`` takes uint8 frames (B,T,H,W,C), like the JAX package,
and returns the five taps: global means over (T,H,W) of s1_fuse, s2_fuse,
s3_fuse, s4_fuse and s5, pathways concatenated — dims
[88, 352, 704, 1408, 2304]. Inside, tensors are NCDHW views of NDHWC memory
(``channels_last_3d``): the fast pathway is a view of the frames, and every
convolution runs on that memory with no transposes (``_conv``).

In eval mode each conv -> BN (-> ReLU) (-> + shortcut -> ReLU) unit runs as
one convolution with BN folded into its weights (``fold_conv``, in float32,
then cast once to the compute dtype) and one pass of
``ops.conv_epilogue`` over its output, in place: the bias, the residual and
the ReLU. That covers the stems, the fuse convs and every canonical
``ResBlock`` (a projection's bias summed into ``c``'s, its raw output
``c``'s residual): 93 passes a forward when K2 runs ``s2``. The folded
weights are made once per dtype and dropped when the weights are loaded,
moved or cast, or the module changes mode (``FoldCache``). Training mode
runs the eager graph (BN, ReLU and adds as their own ops), and
``QuantResBlock`` keeps its own forward.

With ``pallas_stages`` (the JAX package's key) the kt=1, stride-1 slow
stage — ``s2`` on the slow pathway only, where ``slowfast.py:951-952``
routes its Pallas stage — runs as kernel K2 (``ops.bottleneck_kernel``)
with BN folded into the conv weights once in eval mode; on CPU tensors K2's
plain version runs instead. Every other stage is the canonical graph.

``dtype`` (float32 or bfloat16) is the compute dtype, as the JAX package's
``LayerSlowFast(dtype=...)``: the frames are normalized in float32, then
every conv, BN and ReLU runs in it and the taps come out in it. Parameters
stay float32 (flax's ``param_dtype``). In training mode each conv casts its
weight at the call (``models.in_dtype``) and BN computes in float32 on the
input and rounds to the input's dtype, as flax's ``nn.BatchNorm(dtype=...)``
does. In eval mode BN is folded in float32, the folded weights are cast to
the compute dtype and the epilogue adds the float32 bias (and residual) in
float32 and rounds once; K2 likewise takes its weight matrices in the
compute dtype and its biases in float32, as the JAX ``PallasStage`` does.

``fast_block`` is the JAX package's per-stage blocked-T schedule of the
fast pathway: the same function in another layout (JAX
``slowfast.py:298-316``), so the port validates it and runs the canonical
graph for every schedule.

``quant="int8"`` (the JAX package's ``quant``, ``slowfast.py:897-902``)
runs ``s2``..``s5`` on both pathways with int8 convs (``QuantResBlock``,
``models/quant.py``); the stems and fuse convs stay fp, and the int8 stage
takes precedence over ``pallas_stages``, so K2 does not run. ``calibrate``
is the one fp observation pass that sets the activation scales. With a
``fast_block`` schedule the JAX package quantizes its blocked kernels per
blocked output channel (``QuantBlockedBottleneck``); every blocked column
holds the kt canonical taps of one output channel and exact zeros, so its
scale and int8 weights equal the canonical channel's, and activation
scales are per tensor: the port's canonical int8 graph is the same
function in every layout (``tests/test_torch_quant.py`` pins it). The
observers' maxima are buffers outside ``state_dict`` (a PySlowFast
checkpoint has none): ``quant_state_dict``/``load_quant_state_dict`` carry
them, and ``quant_state_from_flax`` reads the JAX package's ``quant``
collection.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import compute_dtype, in_dtype, register_model
from . import quant as q
from .. import tracing
from ..ops.bottleneck_kernel import fold_bn, fused_stage, pack_block
from ..ops.conv_epilogue import conv_epilogue
from ..ops.nonlocal_kernel import nonlocal_core

LAYER_DIMS = [88, 352, 704, 1408, 2304]

ALPHA = 4  # slow/fast frame-rate ratio
BETA_INV = 8  # fast channel reduction
FUSION_CONV_RATIO = 2
FUSION_KERNEL = 7
STAGE_BLOCKS = [3, 4, 6, 3]
SLOW_TEMP_KERNELS = [1, 1, 1, 3, 3]  # stem, s2..s5
FAST_TEMP_KERNELS = [5, 3, 3, 3, 3]
SPATIAL_STRIDES = [1, 2, 2, 2]
# SLOWFAST_NLN_8x8_R50 (PySlowFast configs/Kinetics/SLOWFAST_NLN_8x8_R50.yaml):
# non-local blocks on the slow pathway after these blocks of s2..s5
NLN_LOCATION = ((), (1, 3), (1, 3, 5), ())
NLN_POOL = (1, 2, 2)
NLN_INSTANTIATIONS = ("dot_product", "softmax")
DATA_MEAN = (0.45, 0.45, 0.45)
DATA_STD = (0.225, 0.225, 0.225)
BN_EPS = 1e-5


def _bn(c: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=BN_EPS)


def fold_conv(conv: nn.Conv3d, bn: nn.BatchNorm3d) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv -> inference BN as one conv: (weight * mul, add), computed in
    float32 whatever the parameters' dtype, the weight in conv's
    (O, I, kt, kh, kw) shape."""
    mul, add = fold_bn(*(t.float() for t in (bn.weight, bn.bias, bn.running_mean,
                                             bn.running_var)), bn.eps)
    return conv.weight.float() * mul.view(-1, 1, 1, 1, 1), add


def _plane(conv: nn.Conv3d) -> Optional[str]:
    """The 2-d convolution over a view of NDHWC memory that computes
    ``conv``: ``time`` for a kernel that leaves space alone ((kt, 1, 1), no
    spatial stride or padding), over (T, H*W); ``space`` for one that leaves
    time alone (kt 1, no temporal stride or padding), over the N*T frames;
    None for one with both extents (the fast stem's (5, 7, 7)). cuDNN has
    NHWC kernels for those 2-d forms where its 3-d ones take a generic
    (``indexed``) kernel, or in bf16 a float32 FMA fallback."""
    if conv.dilation != (1, 1, 1) or conv.groups != 1:
        return None
    (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = conv.kernel_size, conv.stride, conv.padding
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return "time"
    if (kt, st, pt) == (1, 1, 0):
        return "space"
    return None


def _fold_cl(conv: nn.Conv3d, bn: nn.BatchNorm3d, dtype: torch.dtype):
    """``fold_conv`` with the weight cast once to ``dtype`` and laid out
    channels-last, as cuDNN's NHWC kernels take it: 4-d for the 2-d
    convolution ``_plane`` names, else 5-d."""
    w, add = fold_conv(conv, bn)
    w = w.to(dtype).contiguous(memory_format=torch.channels_last_3d)
    o, i, kt, kh, kw = w.shape
    plane = _plane(conv)
    if plane:
        rows, cols = (kt, 1) if plane == "time" else (kh, kw)
        w = w.permute(0, 2, 3, 4, 1).reshape(o, rows, cols, i).permute(0, 3, 1, 2)
    return w, add


def _conv(conv: nn.Conv3d, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """conv's geometry on its folded weight ``w`` (``_fold_cl``), no bias,
    on channels-last x; the output channels-last. A 4-d ``w`` runs as the
    2-d convolution ``_plane`` names, on a view of x's memory, its output
    viewed back as 5-d."""
    x = x.contiguous(memory_format=torch.channels_last_3d)  # a no-op between folded units
    n, c, t, h, wd = x.shape
    if w.dim() == 4:
        (st, sh, sw), (pt, ph, pw) = conv.stride, conv.padding
        if _plane(conv) == "time":
            y = F.conv2d(x.as_strided((n, c, t, h * wd), (t * h * wd * c, 1, h * wd * c, c)),
                         w, None, (st, 1), (pt, 0))
            t5, h5, w5 = y.shape[2], h, wd
        else:
            y = F.conv2d(x.as_strided((n * t, c, h, wd), (h * wd * c, 1, wd * c, c)),
                         w, None, (sh, sw), (ph, pw))
            t5, h5, w5 = t, y.shape[2], y.shape[3]
        y = y.contiguous(memory_format=torch.channels_last)
        o = y.shape[1]
        return y.as_strided((n, o, t5, h5, w5), (t5 * h5 * w5 * o, 1, h5 * w5 * o, w5 * o, o))
    if x.is_cuda and x.dtype == torch.bfloat16 and c < 8:
        # cuDNN's bf16 kernels for a 3-d kernel on fewer than 8 channels are
        # generic ones (the fast stem: 37 ms a batch of 32 on an H100, 15 ms
        # in TF32). TF32 holds bf16 values exactly, so its products and
        # float32 sums are those of the bf16 convolution, rounded once:
        # TF32 is on here whatever the caller set.
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            y = conv._conv_forward(x.float(), w.float(), None).to(torch.bfloat16)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    else:
        y = conv._conv_forward(x, w, None)
    return y.contiguous(memory_format=torch.channels_last_3d)


class FoldCache(nn.Module):
    """A module whose derived weights (BN folded, packed, quantized) are made
    once per key in eval mode and kept until the weights are loaded, moved
    or cast, or the module changes mode; in training mode they are made at
    each call. The eval-mode weights are made without autograd."""

    _folded_cache: Optional[dict] = None

    def _cached(self, key, make):
        if self.training:
            return make()
        if self._folded_cache is None:
            self._folded_cache = {}
        if key not in self._folded_cache:
            with torch.inference_mode(False), torch.no_grad():
                self._folded_cache[key] = make()
        return self._folded_cache[key]

    def _eval_folds(self, key, make):
        """``_cached`` for the folded weights that stand in for conv and BN
        in the eval graph. With autograd on and parameters that require
        grad it raises rather than leave them without gradients: run an
        eval-mode forward under ``torch.no_grad()`` or
        ``torch.inference_mode()``, or train in training mode."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            raise RuntimeError(
                f"{type(self).__name__} in eval mode folds BN into its weights without "
                "autograd, so its parameters would get no gradients: run it under "
                "torch.no_grad() or torch.inference_mode(), or in training mode")
        return self._cached(key, make)

    def train(self, mode: bool = True):
        self._folded_cache = None
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._folded_cache = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded_cache = None
        super()._load_from_state_dict(*args, **kwargs)


class ResNetBasicStem(FoldCache):
    """Stem conv (kt,7,7) stride (1,2,2) + BN/ReLU + max pool 1x3x3 stride
    1x2x2 (padding 1; torch pads a max pool with -inf, as flax does)."""

    def __init__(self, dim_in: int, dim_out: int, kt: int):
        super().__init__()
        self.conv = nn.Conv3d(dim_in, dim_out, (kt, 7, 7), stride=(1, 2, 2),
                              padding=(kt // 2, 3, 3), bias=False)
        self.bn = _bn(dim_out)
        self.relu = nn.ReLU(inplace=True)
        self.pool_layer = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))

    def forward(self, x):
        if self.training:
            return self.pool_layer(self.relu(self.bn(in_dtype(self.conv, x))))
        w, b = self._eval_folds(x.dtype, lambda: _fold_cl(self.conv, self.bn, x.dtype))
        return self.pool_layer(conv_epilogue(_conv(self.conv, w, x), b))


class VideoModelStem(nn.Module):
    def __init__(self, width: int = 64):
        super().__init__()
        self.pathway0_stem = ResNetBasicStem(3, width, SLOW_TEMP_KERNELS[0])
        self.pathway1_stem = ResNetBasicStem(3, width // BETA_INV, FAST_TEMP_KERNELS[0])

    def forward(self, slow, fast):
        return self.pathway0_stem(slow), self.pathway1_stem(fast)


class FuseFastToSlow(FoldCache):
    def __init__(self, fast_channels: int):
        super().__init__()
        k = FUSION_KERNEL
        self.conv_f2s = nn.Conv3d(
            fast_channels, fast_channels * FUSION_CONV_RATIO, (k, 1, 1),
            stride=(ALPHA, 1, 1), padding=(k // 2, 0, 0), bias=False)
        self.bn = _bn(fast_channels * FUSION_CONV_RATIO)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, slow, fast):
        if self.training:
            f2s = self.relu(self.bn(in_dtype(self.conv_f2s, fast)))
        else:
            w, b = self._eval_folds(fast.dtype,
                                    lambda: _fold_cl(self.conv_f2s, self.bn, fast.dtype))
            f2s = conv_epilogue(_conv(self.conv_f2s, w, fast), b)
        return torch.cat([slow, f2s], dim=1), fast


class BottleneckTransform(nn.Module):
    """a: (kt,1,1) conv; b: (1,3,3) conv with the spatial stride; c: 1x1x1."""

    def __init__(self, dim_in, dim_out, dim_inner, kt, stride):
        super().__init__()
        self.a = nn.Conv3d(dim_in, dim_inner, (kt, 1, 1), padding=(kt // 2, 0, 0),
                           bias=False)
        self.a_bn = _bn(dim_inner)
        self.b = nn.Conv3d(dim_inner, dim_inner, (1, 3, 3), stride=(1, stride, stride),
                           padding=(0, 1, 1), bias=False)
        self.b_bn = _bn(dim_inner)
        self.c = nn.Conv3d(dim_inner, dim_out, 1, bias=False)
        self.c_bn = _bn(dim_out)

    def forward(self, x):
        x = torch.relu(self.a_bn(in_dtype(self.a, x)))
        x = torch.relu(self.b_bn(in_dtype(self.b, x)))
        return self.c_bn(in_dtype(self.c, x))


class ResBlock(FoldCache):
    """A bottleneck block with its shortcut. In eval mode: ``a`` and ``b``
    folded, each with a bias + ReLU epilogue; the projection ``branch1``
    folded with no epilogue, its bias summed into ``c``'s; ``c`` folded with
    one epilogue of bias, residual (``branch1``'s raw output or the input)
    and ReLU."""

    def __init__(self, dim_in, dim_out, dim_inner, kt, stride):
        super().__init__()
        self.stride = stride
        if dim_in != dim_out or stride != 1:
            self.branch1 = nn.Conv3d(dim_in, dim_out, 1, stride=(1, stride, stride),
                                     bias=False)
            self.branch1_bn = _bn(dim_out)
        self.branch2 = BottleneckTransform(dim_in, dim_out, dim_inner, kt, stride)

    def forward(self, x):
        return self._eager(x) if self.training else self._folded_forward(x)

    def _folded_forward(self, x, observe=None):
        """The eval-mode block; ``observe(site, t)``, where given, sees each
        conv input (``QUANT_SITES``: x, then ``a``'s and ``b``'s outputs)."""
        w, t = self._folds(x.dtype), self.branch2
        if observe:
            observe("q_in", x)
        shortcut = _conv(self.branch1, w["branch1"][0], x) if hasattr(self, "branch1") else x
        h = conv_epilogue(_conv(t.a, w["a"][0], x), w["a"][1])
        if observe:
            observe("q_a", h)
        h = conv_epilogue(_conv(t.b, w["b"][0], h), w["b"][1])
        if observe:
            observe("q_b", h)
        return conv_epilogue(_conv(t.c, w["c"][0], h), w["c"][1], shortcut)

    def _eager(self, x):
        shortcut = (self.branch1_bn(in_dtype(self.branch1, x)) if hasattr(self, "branch1")
                    else x)
        return torch.relu(shortcut + self.branch2(x))

    def _folds(self, dtype: torch.dtype) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """{conv: (folded channels-last weight in ``dtype``, float32 bias)}
        for ``a``, ``b``, ``c`` and ``branch1``, ``c``'s bias with
        ``branch1``'s added."""
        def make():
            t = self.branch2
            out = {"a": _fold_cl(t.a, t.a_bn, dtype), "b": _fold_cl(t.b, t.b_bn, dtype),
                   "c": _fold_cl(t.c, t.c_bn, dtype)}
            if hasattr(self, "branch1"):
                out["branch1"] = _fold_cl(self.branch1, self.branch1_bn, dtype)
                out["c"] = (out["c"][0], out["c"][1] + out["branch1"][1])
            return out

        return self._eval_folds(dtype, make)

    def folded(self) -> Dict[str, torch.Tensor]:
        """BN-folded weights in kernel K2's layout (the counterpart of the
        JAX package's ``_PallasBottleneckParams``); kt must be 1."""
        t = self.branch2

        def fold(conv, bn):
            w, add = fold_conv(conv, bn)
            w = w[:, :, 0]  # (O, I, kh, kw)
            if w.shape[-1] == 1:
                return w[:, :, 0, 0].t().contiguous(), add.contiguous()
            return w.permute(2, 3, 1, 0).contiguous(), add.contiguous()

        out = {}
        out["aw"], out["ab"] = fold(t.a, t.a_bn)
        out["bw"], out["bb"] = fold(t.b, t.b_bn)
        out["cw"], out["cb"] = fold(t.c, t.c_bn)
        if hasattr(self, "branch1"):
            out["pw"], out["pb"] = fold(self.branch1, self.branch1_bn)
        return out


class Nonlocal(nn.Module):
    """PySlowFast's non-local block (``slowfast/models/nonlocal_helper.py``,
    Wang et al. 2018), space-time self-attention inside the CNN:

        theta = conv_theta(x); phi, g = conv_phi(p), conv_g(p), p = maxpool(x)
        S = theta^T phi (Nq x Nk); dot_product: S / Nk, softmax:
        softmax(S * dim_inner^-1/2) over the keys
        y = S g^T -> (N, dim_inner, T, H, W); out = x + bn(conv_out(y))

    with 1x1x1 convs (biases) dim -> dim_inner (dim // 2) and back, the max
    pool's kernel and stride ``pool``, and inference BN. ``dot_product``'s
    core runs as ``ops.nonlocal_kernel.nonlocal_core`` (the cheaper order
    ``(g phi^T / Nk) theta``, the same function; the kernel on bf16 CUDA
    tensors), ``softmax`` in the published order. Convs, BN and the residual
    run in x's dtype as every block does, in x's layout (channels-last
    between the folded blocks); theta, phi and g are reshaped to
    (N, Ci, THW) for the core, and y back to x's layout, a copy each.
    Each block counts in the tracing
    counter ``nonlocal.blocks`` and its enqueue is the span
    ``span.extract.nonlocal``."""

    def __init__(self, dim: int, dim_inner: Optional[int] = None,
                 pool: Sequence[int] = NLN_POOL, instantiation: str = "dot_product"):
        super().__init__()
        if instantiation not in NLN_INSTANTIATIONS:
            raise ValueError(f"non-local instantiation {instantiation!r} is not one of "
                             f"{NLN_INSTANTIATIONS}")
        self.dim_inner = dim_inner or dim // 2
        self.instantiation = instantiation
        self.conv_theta = nn.Conv3d(dim, self.dim_inner, 1)
        self.conv_phi = nn.Conv3d(dim, self.dim_inner, 1)
        self.conv_g = nn.Conv3d(dim, self.dim_inner, 1)
        self.conv_out = nn.Conv3d(self.dim_inner, dim, 1)
        self.bn = _bn(dim)
        pool = tuple(pool)
        self.pool = nn.MaxPool3d(pool, pool) if any(k > 1 for k in pool) else None

    def forward(self, x):
        with tracing.span("span.extract.nonlocal"):
            n, _, t, h, w = x.shape
            ci = self.dim_inner
            theta = in_dtype(self.conv_theta, x).reshape(n, ci, -1)
            p = x if self.pool is None else self.pool(x)
            phi = in_dtype(self.conv_phi, p).reshape(n, ci, -1)
            g = in_dtype(self.conv_g, p).reshape(n, ci, -1)
            if self.instantiation == "dot_product":
                y = nonlocal_core(theta, phi, g)
            else:
                s = torch.einsum("nct,ncp->ntp", theta, phi) * ci ** -0.5
                y = torch.einsum("ntg,ncg->nct", torch.softmax(s, dim=2), g)
            # y in x's layout, so that conv_out, BN and the residual add run on
            # like layouts (a mixed-layout add is a strided, unvectorized pass)
            cl = x.permute(0, 2, 3, 4, 1).is_contiguous()
            y = y.reshape(n, ci, t, h, w).contiguous(
                memory_format=torch.channels_last_3d if cl else torch.contiguous_format)
            out = x + self.bn(in_dtype(self.conv_out, y))
            tracing.count("nonlocal.blocks")
        return out


QUANT_SITES = ("q_in", "q_a", "q_b")  # the observed inputs of branch1/a, b, c


class QuantResBlock(ResBlock):
    """``ResBlock`` with int8 conv arithmetic (JAX ``QuantBottleneck``,
    ``slowfast.py:462-553``): the same parameters plus one abs-max observer
    per conv input (``q_in``, ``q_a``, ``q_b``; non-persistent buffers).

    mode ``calib``: ``ResBlock``'s fp math (in eval mode its folded graph,
    the one the fp model runs) while the observers keep running maxima.
    mode ``int8``: the input and the two inner activations quantize
    against the frozen scales, the convs run int8 with int32 sums
    (``quant.qconv``), BN and ReLU stay in the compute dtype. The identity
    shortcut is the dequantized input ``xq * s_in``, a projection shortcut
    ``BN(qconv(xq))``. The int8 weight matrices and scales are made once in
    eval mode and kept until the weights are loaded or moved or the module
    changes mode (``FoldCache``). Mode ``none`` is ``ResBlock``'s forward."""

    def __init__(self, *args):
        super().__init__(*args)
        for site in QUANT_SITES:
            self.register_buffer(site, torch.zeros(()), persistent=False)

    def _convs(self) -> Dict[str, nn.Conv3d]:
        t = self.branch2
        convs = {"a": t.a, "b": t.b, "c": t.c}
        if hasattr(self, "branch1"):
            convs["branch1"] = self.branch1
        return convs

    def quantized_weights(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """{conv: (int8 (Cout, K) matrix, float32 scale (Cout,))}."""
        def make():
            with torch.inference_mode(False), torch.no_grad():
                made = {}
                for name, conv in self._convs().items():
                    wq, sw = q.weight_qparams(conv.weight)
                    made[name] = (q.weight_matrix(wq), sw)
            return made

        return self._cached("int8", make)

    def _site(self, site: str, x: torch.Tensor, mode: str):
        """A conv input at observer ``site`` -> (what the convs take, its
        scale): calib raises the running maximum and passes ``x`` on with no
        scale; int8 quantizes ``x`` against the frozen scale. The maximum is
        a new tensor, not an in-place update, so the observer follows the
        batch whether the model or the batch was made under
        ``torch.inference_mode`` or not."""
        if mode == "calib":
            with torch.no_grad():
                amax = x.detach().abs().amax().float()
                setattr(self, site, torch.maximum(getattr(self, site), amax))
            return x, None
        s = q.act_scale(getattr(self, site))
        return q.quantize_act(x, s), s

    def _conv(self, name: str, conv: nn.Conv3d, x: torch.Tensor, s: Optional[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
        """``conv`` on a ``_site`` output: fp without a scale, int8 with one."""
        if s is None:
            return in_dtype(conv, x)
        return q.qconv(x, s, *self.quantized_weights()[name], conv, dtype)

    def forward(self, x, mode: str = "int8"):
        if mode == "none":
            return super().forward(x)
        if mode not in ("calib", "int8"):
            raise ValueError(f"quant mode {mode!r} is not one of {q.MODES}")
        if mode == "calib" and not self.training:
            return self._folded_forward(x, lambda site, t: self._site(site, t, mode))
        dtype, t = x.dtype, self.branch2
        xs, s_in = self._site("q_in", x, mode)
        if hasattr(self, "branch1"):
            shortcut = self.branch1_bn(self._conv("branch1", self.branch1, xs, s_in, dtype))
        else:  # int8: the dequantized input
            shortcut = x if s_in is None else (xs.float() * s_in).to(dtype)
        h = torch.relu(t.a_bn(self._conv("a", t.a, xs, s_in, dtype)))
        h = torch.relu(t.b_bn(self._conv("b", t.b, *self._site("q_a", h, mode), dtype)))
        h = t.c_bn(self._conv("c", t.c, *self._site("q_b", h, mode), dtype))
        return torch.relu(shortcut + h)


class ResStage(FoldCache):
    """One stage of both pathways: ``pathway{p}_res{i}`` blocks;
    ``QuantResBlock``s where ``quant``, which then take precedence over
    ``fused_slow``. ``nonlocal_idx`` places a ``Nonlocal`` (of
    ``instantiation``) after each of those slow-pathway blocks, as
    ``pathway0_nonlocal{i}`` (PySlowFast's ``ResStage``); a stage with one
    runs its slow blocks on the canonical graph, never K2, and takes no
    ``quant``."""

    def __init__(self, si: int, dim_in: Tuple[int, int], fused_slow: bool = False,
                 quant: bool = False, nonlocal_idx: Sequence[int] = (),
                 instantiation: str = "dot_product"):
        super().__init__()
        self.nonlocal_idx = tuple(sorted(set(int(i) for i in nonlocal_idx)))
        if self.nonlocal_idx and quant:
            raise ValueError("int8 has no non-local block: quant='int8' takes a model "
                             "without them")
        if any(not 0 <= i < STAGE_BLOCKS[si] for i in self.nonlocal_idx):
            raise ValueError(f"non-local blocks {self.nonlocal_idx} outside stage s{si + 2}'s "
                             f"{STAGE_BLOCKS[si]} blocks")
        fused_slow = fused_slow and not self.nonlocal_idx
        w = 64
        dim_out = w * 4 * 2 ** si
        dim_inner = w * 2 ** si
        self.stride = SPATIAL_STRIDES[si]
        self.fused_slow = fused_slow and not quant
        self.quant = quant
        block = QuantResBlock if quant else ResBlock
        for p, (cin, cout, inner, kt) in enumerate((
                (dim_in[0], dim_out, dim_inner, SLOW_TEMP_KERNELS[si + 1]),
                (dim_in[1], dim_out // BETA_INV, dim_inner // BETA_INV,
                 FAST_TEMP_KERNELS[si + 1]))):
            for i in range(STAGE_BLOCKS[si]):
                self.add_module(f"pathway{p}_res{i}", block(
                    cin if i == 0 else cout, cout, inner, kt,
                    self.stride if i == 0 else 1))
                if p == 0 and i in self.nonlocal_idx:
                    self.add_module(f"pathway0_nonlocal{i}", Nonlocal(
                        cout, cout // 2, NLN_POOL, instantiation))
        self.num_blocks = STAGE_BLOCKS[si]

    def _blocks(self, p: int) -> List[ResBlock]:
        return [getattr(self, f"pathway{p}_res{i}") for i in range(self.num_blocks)]

    def _fold(self, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """BN folded in float32, then the weight matrices (not the biases)
        cast to the compute dtype, as the JAX kernel's ``add_w`` casts them."""
        return [{k: v.to(dtype) if v.dim() > 1 else v for k, v in blk.folded().items()}
                for blk in self._blocks(0)]

    def _folded(self, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """The slow blocks' BN-folded weights for K2 in ``dtype``, folded
        once per dtype in eval mode (``FoldCache``)."""
        return self._cached(dtype, lambda: self._fold(dtype))

    def _packed(self, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """The folded weights in ``dtype`` packed for K2's kernel of that
        dtype (``pack_block``), kept beside them and dropped with them."""
        folded = self._folded(dtype)
        return self._cached(("packed", dtype), lambda: [pack_block(blk) for blk in folded])

    def _fused(self, x):
        """Kernel K2 on folded frames: (B,C,T,H,W) channels-last -> NHWC
        frames -> back, views on both sides."""
        b, c, t, h, w = x.shape
        frames = x.permute(0, 2, 3, 4, 1).reshape(b * t, h, w, c)
        packed = self._packed(x.dtype) if x.is_cuda else None
        y = fused_stage(frames, self._folded(x.dtype), stride=self.stride, packed=packed)
        return y.reshape(b, t, *y.shape[1:]).permute(0, 4, 1, 2, 3)

    def forward(self, slow, fast, mode: str = "none"):
        if self.quant:
            for blk in self._blocks(0):
                slow = blk(slow, mode)
            for blk in self._blocks(1):
                fast = blk(fast, mode)
            return slow, fast
        if self.fused_slow:
            slow = self._fused(slow)
        else:
            for i, blk in enumerate(self._blocks(0)):
                slow = blk(slow)
                if i in self.nonlocal_idx:
                    slow = getattr(self, f"pathway0_nonlocal{i}")(slow)
        for blk in self._blocks(1):
            fast = blk(fast)
        return slow, fast


def _pool_all(slow, fast):
    """Global mean over (T,H,W), pathways concatenated, in the compute
    dtype (JAX ``slowfast.py:867``)."""
    return torch.cat([slow.mean(dim=(2, 3, 4)), fast.mean(dim=(2, 3, 4))], dim=-1)


def check_fast_block(fast_block: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """The JAX package's ``fast_block`` (None, or 5 frame counts for s1..s5,
    0 or 1 meaning the canonical layout) -> a tuple of 5; raises on anything
    else. JAX takes the blocked layout where some count is above 1 and every
    count divides T, and falls back to the canonical one otherwise; both are
    the same function, which the port computes in the canonical layout."""
    fb = tuple(fast_block or (0,) * 5)
    if len(fb) != 5 or not all(isinstance(f, (int, np.integer)) and not isinstance(f, bool)
                               and f >= 0 for f in fb):
        raise ValueError(f"fast_block takes 5 frame counts >= 0 (s1..s5), got {fast_block!r}")
    return tuple(int(f) for f in fb)


def check_quant(quant: Optional[str]) -> str:
    """The JAX package's ``computation.quant``: ``none`` (or None) or
    ``int8``; raises on any other string, which the JAX package would run
    as int8 (``slowfast.py:907``)."""
    quant = quant or "none"
    if quant not in ("none", "int8"):
        raise ValueError(f"quant takes 'none' or 'int8', got {quant!r}")
    return quant


def check_nonlocal(location: Sequence[Sequence[int]]) -> Tuple[Tuple[int, ...], ...]:
    """Non-local locations: 4 lists of slow-pathway block indices, one a
    stage s2..s5 (PySlowFast's ``NONLOCAL.LOCATION`` of the slow pathway)."""
    loc = tuple(tuple(int(i) for i in stage) for stage in location)
    if len(loc) != 4:
        raise ValueError(f"non-local location takes 4 lists (s2..s5), got {location!r}")
    return loc


class SlowFastBackbone(nn.Module):
    """Returns the 5 layer taps in ``dtype``; inputs slow (B,3,T/4,H,W),
    fast (B,3,T,H,W), cast to ``dtype`` on the way in. ``nonlocal_location``
    (``check_nonlocal``) places non-local blocks of ``nonlocal_instantiation``
    on the slow pathway."""

    def __init__(self, pallas_stages: bool = True, dtype=torch.float32,
                 fast_block: Optional[Sequence[int]] = None, quant: str = "none",
                 nonlocal_location: Sequence[Sequence[int]] = ((), (), (), ()),
                 nonlocal_instantiation: str = "dot_product"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.fast_block = check_fast_block(fast_block)
        self.quant = check_quant(quant)
        self.nonlocal_location = check_nonlocal(nonlocal_location)
        if self.quant == "int8" and any(self.nonlocal_location):
            raise ValueError("int8 has no non-local block: quant='int8' takes a model "
                             "without them")
        w = 64
        self.s1 = VideoModelStem(w)
        self.s1_fuse = FuseFastToSlow(w // BETA_INV)
        slow_in, fast_in = w + 2 * w // BETA_INV, w // BETA_INV
        for si in range(4):
            fused = (pallas_stages and SLOW_TEMP_KERNELS[si + 1] == 1
                     and SPATIAL_STRIDES[si] == 1)
            self.add_module(f"s{si + 2}", ResStage(
                si, (slow_in, fast_in), fused, quant=self.quant == "int8",
                nonlocal_idx=self.nonlocal_location[si],
                instantiation=nonlocal_instantiation))
            dim_out = w * 4 * 2 ** si
            if si < 3:
                self.add_module(f"s{si + 2}_fuse", FuseFastToSlow(dim_out // BETA_INV))
                slow_in = dim_out + 2 * dim_out // BETA_INV
            else:
                slow_in = dim_out
            fast_in = dim_out // BETA_INV

    def forward(self, slow, fast, quant_mode: Optional[str] = None) -> List[torch.Tensor]:
        """``quant_mode`` (``quant.MODES``) defaults to ``int8`` for an int8
        backbone and ``none`` otherwise. The inputs are cast and laid out
        channels-last in one copy (none where they already are)."""
        mode = quant_mode or ("int8" if self.quant == "int8" else "none")
        slow, fast = (t.to(self.dtype, memory_format=torch.channels_last_3d)
                      for t in (slow, fast))
        slow, fast = self.s1(slow, fast)
        slow, fast = self.s1_fuse(slow, fast)
        taps = [_pool_all(slow, fast)]  # 88
        for si in range(4):
            slow, fast = getattr(self, f"s{si + 2}")(slow, fast, mode)
            if si < 3:
                slow, fast = getattr(self, f"s{si + 2}_fuse")(slow, fast)
            taps.append(_pool_all(slow, fast))  # 352 704 1408 2304
        return taps

    def _quant_blocks(self):
        return [(name, mod) for name, mod in self.named_modules()
                if isinstance(mod, QuantResBlock)]

    def quant_state_dict(self) -> "OrderedDict[str, torch.Tensor]":
        """The observers' running maxima, ``{block}.{q_in,q_a,q_b}``."""
        return OrderedDict((f"{name}.{site}", getattr(blk, site).detach().clone())
                           for name, blk in self._quant_blocks() for site in QUANT_SITES)

    def load_quant_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Loads every observer's maximum; raises on a missing or extra key."""
        want = set(self.quant_state_dict())
        if set(state) != want:
            raise KeyError(f"quant state keys: missing {sorted(want - set(state))}, "
                           f"unexpected {sorted(set(state) - want)}")
        for name, blk in self._quant_blocks():
            for site in QUANT_SITES:
                buf = getattr(blk, site)
                setattr(blk, site, torch.as_tensor(state[f"{name}.{site}"]).detach().to(
                    device=buf.device, dtype=buf.dtype).clone())


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (B,T,H,W,C) -> normalized float32 ((x/255 - mean)/std)."""
    x = frames.to(torch.float32) / 255.0
    mean = torch.tensor(DATA_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(DATA_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def pack_pathways(frames: torch.Tensor):
    """(B,T,H,W,C) -> (slow (B,T/4,...), fast (B,T,...)): the slow pathway
    takes every ALPHA-th frame."""
    return frames[:, ::ALPHA], frames


@register_model("layer_slow_fast")  # reference config.py:2 spelling
@register_model("layer_slowfast")
class LayerSlowFast(SlowFastBackbone):
    """Layer-tapped SlowFast over uint8 frame batches (B,T,H,W,3)."""

    output_dims = LAYER_DIMS
    model_tag = {"name": "SLOWFAST_8x8_R50", "dataset": "kinetics-400"}
    media_type = "video"

    def __init__(self, pallas_stages: bool = True, dtype=torch.float32,
                 fast_block: Optional[Sequence[int]] = None, quant: str = "none",
                 nonlocal_location: Sequence[Sequence[int]] = ((), (), (), ()),
                 nonlocal_instantiation: str = "dot_product"):
        super().__init__(pallas_stages=pallas_stages, dtype=dtype, fast_block=fast_block,
                         quant=quant, nonlocal_location=nonlocal_location,
                         nonlocal_instantiation=nonlocal_instantiation)
        self.eval()

    def forward(self, frames: torch.Tensor, quant_mode: Optional[str] = None
                ) -> List[torch.Tensor]:
        """uint8 frames (B,T,H,W,3) -> the 5 taps (B, dim) in ``dtype``."""
        slow, fast = pack_pathways(normalize_frames(frames))
        to_ncdhw = (0, 4, 1, 2, 3)  # views: NDHWC memory is channels_last_3d
        return SlowFastBackbone.forward(
            self, slow.permute(*to_ncdhw), fast.permute(*to_ncdhw), quant_mode)

    @torch.no_grad()
    def calibrate(self, frames: torch.Tensor) -> None:
        """One observation pass (the fp graph) raising the observers'
        running maxima to this batch's (JAX ``LayerSlowFast.calibrate``);
        ``run_extraction`` calls it on its first batch."""
        if self.quant != "int8":
            raise ValueError("calibrate needs an int8 model (quant='int8')")
        LayerSlowFast.forward(self, frames, quant_mode="calib")


@register_model("slow_fast")  # reference model_types spelling
@register_model("slowfast")
class SlowFast(LayerSlowFast):
    """Final-layer-only variant (2304-d; reference slowfast.py:31-95)."""

    output_dims = 2304

    def forward(self, frames):
        return super().forward(frames)[-1]


@register_model("layer_slowfast_nln")
class LayerSlowFastNln(LayerSlowFast):
    """SLOWFAST_NLN_8x8_R50 (PySlowFast ``configs/Kinetics/SLOWFAST_NLN_8x8_R50.yaml``):
    ``LayerSlowFast`` with non-local blocks (``Nonlocal``, ``dot_product``,
    pool 1x2x2, dim_inner dim/2) on the slow pathway after blocks 1 and 3 of
    ``s3`` and 1, 3 and 5 of ``s4``; the same five taps. K2 still runs ``s2``,
    which has none; int8 raises."""

    model_tag = {"name": "SLOWFAST_NLN_8x8_R50", "dataset": "kinetics-400"}

    def __init__(self, pallas_stages: bool = True, dtype=torch.float32,
                 fast_block: Optional[Sequence[int]] = None, quant: str = "none",
                 nonlocal_location: Sequence[Sequence[int]] = NLN_LOCATION,
                 nonlocal_instantiation: str = "dot_product"):
        super().__init__(pallas_stages, dtype, fast_block, quant, nonlocal_location,
                         nonlocal_instantiation)


def zero_init_final_bn(model: nn.Module) -> None:
    """ZERO_INIT_FINAL_BN: gamma 0 on every block's last BN, as the JAX
    package's flax init does (``slowfast.py:100-104``), and on every
    non-local block's BN, as PySlowFast's ``zero_init_final_norm`` sets it."""
    for mod in model.modules():
        if isinstance(mod, BottleneckTransform):
            nn.init.zeros_(mod.c_bn.weight)
        elif isinstance(mod, Nonlocal):
            nn.init.zeros_(mod.bn.weight)


# -- flax <-> PySlowFast names --------------------------------------------------

def _flax_pairs():
    """(PySlowFast prefix, flax module path, kind) for every module: kind
    ``conv`` (a kernel), ``conv_bias`` (a kernel and a bias: a non-local
    block's convs) or ``bn``. The non-local blocks' entries, under
    ``s{k}_slow/nonlocal{i}`` (the port's own names: the JAX package has no
    non-local block), are listed after every slow-pathway block and taken
    where present."""
    out = []
    for pw, tag in ((0, "slow"), (1, "fast")):
        out.append((f"s1.pathway{pw}_stem.conv", (f"s1_{tag}", "conv"), "conv"))
        out.append((f"s1.pathway{pw}_stem.bn", (f"s1_{tag}", "bn", "BatchNorm_0"), "bn"))
    for i in range(1, 5):
        out.append((f"s{i}_fuse.conv_f2s", (f"s{i}_fuse", "conv_f2s"), "conv"))
        out.append((f"s{i}_fuse.bn", (f"s{i}_fuse", "bn", "BatchNorm_0"), "bn"))
    for si in range(4):
        for bi in range(STAGE_BLOCKS[si]):
            for pw, tag in ((0, "slow"), (1, "fast")):
                t = f"s{si + 2}.pathway{pw}_res{bi}"
                f = (f"s{si + 2}_{tag}", f"block{bi}")
                for br in ("a", "b", "c"):
                    out.append((f"{t}.branch2.{br}", f + (f"branch2_{br}",), "conv"))
                    bn = f + (f"branch2_{br}_bn",) + (() if br == "c" else ("BatchNorm_0",))
                    out.append((f"{t}.branch2.{br}_bn", bn, "bn"))
                out.append((f"{t}.branch1", f + ("branch1",), "conv"))
                out.append((f"{t}.branch1_bn", f + ("branch1_bn", "BatchNorm_0"), "bn"))
            t, f = f"s{si + 2}.pathway0_nonlocal{bi}", (f"s{si + 2}_slow", f"nonlocal{bi}")
            for conv in ("conv_theta", "conv_phi", "conv_g", "conv_out"):
                out.append((f"{t}.{conv}", f + (conv,), "conv_bias"))
            out.append((f"{t}.bn", f + ("bn",), "bn"))
    return out


def _get(tree, path):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``{params, batch_stats}`` tree (nested numpy
    dicts) -> the PySlowFast-named ``state_dict`` of ``LayerSlowFast``. The
    inverse of ``acav100m_tpu.models.slowfast.convert_pyslowfast_state_dict``:
    conv kernels DHWIO -> OIDHW; BN scale/bias/mean/var -> weight/bias/
    running_mean/running_var."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.float32)))

    for tkey, path, kind in _flax_pairs():
        node = _get(params, path)
        if node is None:  # blocks without a projection shortcut or a non-local block
            continue
        if kind != "bn":
            put(f"{tkey}.weight", np.asarray(node["kernel"]).transpose(4, 3, 0, 1, 2))
            if kind == "conv_bias":
                put(f"{tkey}.bias", node["bias"])
            continue
        st = _get(stats, path)
        put(f"{tkey}.weight", node["scale"])
        put(f"{tkey}.bias", node["bias"])
        put(f"{tkey}.running_mean", st["mean"])
        put(f"{tkey}.running_var", st["var"])
        sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def quant_state_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``quant`` collection (``s{k}_{slow,fast}/
    block{i}/q_{in,a,b}/amax``) -> ``LayerSlowFast.load_quant_state_dict``'s
    ``s{k}.pathway{p}_res{i}.q_{in,a,b}``."""
    tree = variables["quant"]
    out: Dict[str, torch.Tensor] = {}
    for si in range(4):
        for pw, tag in ((0, "slow"), (1, "fast")):
            for bi in range(STAGE_BLOCKS[si]):
                for site in QUANT_SITES:
                    amax = _get(tree, (f"s{si + 2}_{tag}", f"block{bi}", site, "amax"))
                    out[f"s{si + 2}.pathway{pw}_res{bi}.{site}"] = torch.tensor(
                        float(np.asarray(amax, np.float32)), dtype=torch.float32)
    return out


def _put(tree: Dict, path, leaf) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def convert_pyslowfast_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """A PySlowFast state dict (numpy arrays, caffe2 names already
    translated) -> the JAX package's flax ``{params, batch_stats}`` tree, as
    ``acav100m_tpu.models.slowfast.convert_pyslowfast_state_dict`` makes it:
    conv kernels OIDHW -> DHWIO, BN weight/bias/running_mean/running_var ->
    scale/bias/mean/var. Keys the taps do not use (the head,
    ``num_batches_tracked``) are ignored; a projection shortcut and a
    non-local block (SLOWFAST_NLN_8x8_R50's) are taken where the checkpoint
    has them."""
    params: Dict = {}
    stats: Dict = {}
    for tkey, path, kind in _flax_pairs():
        block = tkey.rsplit(".", 1)[0]
        if tkey.endswith(("branch1", "branch1_bn")) and f"{block}.branch1.weight" not in sd:
            continue
        if "_nonlocal" in block and f"{block}.conv_theta.weight" not in sd:
            continue
        if kind != "bn":
            node = {"kernel": np.asarray(sd[f"{tkey}.weight"]).transpose(2, 3, 4, 1, 0)}
            if kind == "conv_bias":
                node["bias"] = np.asarray(sd[f"{tkey}.bias"])
            _put(params, path, node)
            continue
        _put(params, path, {"scale": np.asarray(sd[f"{tkey}.weight"]),
                            "bias": np.asarray(sd[f"{tkey}.bias"])})
        _put(stats, path, {"mean": np.asarray(sd[f"{tkey}.running_mean"]),
                           "var": np.asarray(sd[f"{tkey}.running_var"])})
    return {"params": params, "batch_stats": stats}
