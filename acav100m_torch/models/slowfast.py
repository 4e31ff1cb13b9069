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
[88, 352, 704, 1408, 2304]. Inside, tensors are NCDHW.

With ``pallas_stages`` (the JAX package's key) the kt=1, stride-1 slow
stage — ``s2`` on the slow pathway only, where ``slowfast.py:951-952``
routes its Pallas stage — runs as kernel K2 (``ops.bottleneck_kernel``)
with BN folded into the conv weights once in eval mode; on CPU tensors K2's
plain version runs instead. Every other stage is the canonical graph.

``dtype`` (float32 or bfloat16) is the compute dtype, as the JAX package's
``LayerSlowFast(dtype=...)``: the frames are normalized in float32, then
every conv, BN and ReLU runs in it and the taps come out in it. Parameters
stay float32 (flax's ``param_dtype``); each conv casts its weight at the
call (``models.in_dtype``) and BN computes in float32 on the input and
rounds to the input's dtype, as flax's ``nn.BatchNorm(dtype=...)`` does. K2
folds BN in float32 and takes its weight matrices in the compute dtype and
its biases in float32, as the JAX ``PallasStage`` does.

``fast_block`` is the JAX package's per-stage blocked-T schedule of the
fast pathway: the same function in another layout (JAX
``slowfast.py:298-316``), so the port validates it and runs the canonical
graph for every schedule.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import compute_dtype, in_dtype, register_model
from ..ops.bottleneck_kernel import fold_bn, fused_stage

LAYER_DIMS = [88, 352, 704, 1408, 2304]

ALPHA = 4  # slow/fast frame-rate ratio
BETA_INV = 8  # fast channel reduction
FUSION_CONV_RATIO = 2
FUSION_KERNEL = 7
STAGE_BLOCKS = [3, 4, 6, 3]
SLOW_TEMP_KERNELS = [1, 1, 1, 3, 3]  # stem, s2..s5
FAST_TEMP_KERNELS = [5, 3, 3, 3, 3]
SPATIAL_STRIDES = [1, 2, 2, 2]
DATA_MEAN = (0.45, 0.45, 0.45)
DATA_STD = (0.225, 0.225, 0.225)
BN_EPS = 1e-5


def _bn(c: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=BN_EPS)


class ResNetBasicStem(nn.Module):
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
        return self.pool_layer(self.relu(self.bn(in_dtype(self.conv, x))))


class VideoModelStem(nn.Module):
    def __init__(self, width: int = 64):
        super().__init__()
        self.pathway0_stem = ResNetBasicStem(3, width, SLOW_TEMP_KERNELS[0])
        self.pathway1_stem = ResNetBasicStem(3, width // BETA_INV, FAST_TEMP_KERNELS[0])

    def forward(self, slow, fast):
        return self.pathway0_stem(slow), self.pathway1_stem(fast)


class FuseFastToSlow(nn.Module):
    def __init__(self, fast_channels: int):
        super().__init__()
        k = FUSION_KERNEL
        self.conv_f2s = nn.Conv3d(
            fast_channels, fast_channels * FUSION_CONV_RATIO, (k, 1, 1),
            stride=(ALPHA, 1, 1), padding=(k // 2, 0, 0), bias=False)
        self.bn = _bn(fast_channels * FUSION_CONV_RATIO)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, slow, fast):
        f2s = self.relu(self.bn(in_dtype(self.conv_f2s, fast)))
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


class ResBlock(nn.Module):
    def __init__(self, dim_in, dim_out, dim_inner, kt, stride):
        super().__init__()
        self.stride = stride
        if dim_in != dim_out or stride != 1:
            self.branch1 = nn.Conv3d(dim_in, dim_out, 1, stride=(1, stride, stride),
                                     bias=False)
            self.branch1_bn = _bn(dim_out)
        self.branch2 = BottleneckTransform(dim_in, dim_out, dim_inner, kt, stride)

    def forward(self, x):
        shortcut = (self.branch1_bn(in_dtype(self.branch1, x)) if hasattr(self, "branch1")
                    else x)
        return torch.relu(shortcut + self.branch2(x))

    def folded(self) -> Dict[str, torch.Tensor]:
        """BN-folded weights in kernel K2's layout (the counterpart of the
        JAX package's ``_PallasBottleneckParams``); kt must be 1."""
        t = self.branch2

        def fold(conv, bn):
            mul, add = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                               bn.eps)
            w = conv.weight[:, :, 0]  # (O, I, kh, kw)
            if w.shape[-1] == 1:
                return (w[:, :, 0, 0].t() * mul).contiguous(), add.contiguous()
            return (w.permute(2, 3, 1, 0) * mul).contiguous(), add.contiguous()

        out = {}
        out["aw"], out["ab"] = fold(t.a, t.a_bn)
        out["bw"], out["bb"] = fold(t.b, t.b_bn)
        out["cw"], out["cb"] = fold(t.c, t.c_bn)
        if hasattr(self, "branch1"):
            out["pw"], out["pb"] = fold(self.branch1, self.branch1_bn)
        return out


class ResStage(nn.Module):
    """One stage of both pathways: ``pathway{p}_res{i}`` blocks."""

    def __init__(self, si: int, dim_in: Tuple[int, int], fused_slow: bool = False):
        super().__init__()
        w = 64
        dim_out = w * 4 * 2 ** si
        dim_inner = w * 2 ** si
        self.stride = SPATIAL_STRIDES[si]
        self.fused_slow = fused_slow
        for p, (cin, cout, inner, kt) in enumerate((
                (dim_in[0], dim_out, dim_inner, SLOW_TEMP_KERNELS[si + 1]),
                (dim_in[1], dim_out // BETA_INV, dim_inner // BETA_INV,
                 FAST_TEMP_KERNELS[si + 1]))):
            for i in range(STAGE_BLOCKS[si]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    cin if i == 0 else cout, cout, inner, kt,
                    self.stride if i == 0 else 1))
        self.num_blocks = STAGE_BLOCKS[si]
        self._folded_cache = None

    def _blocks(self, p: int) -> List[ResBlock]:
        return [getattr(self, f"pathway{p}_res{i}") for i in range(self.num_blocks)]

    def _fold(self, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """BN folded in float32, then the weight matrices (not the biases)
        cast to the compute dtype, as the JAX kernel's ``add_w`` casts them."""
        return [{k: v.to(dtype) if v.dim() > 1 else v for k, v in blk.folded().items()}
                for blk in self._blocks(0)]

    def _folded(self, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """The slow blocks' BN-folded weights for K2 in ``dtype``. In eval
        mode they are folded once per dtype and kept until the weights are
        loaded, moved or cast, or the module changes mode."""
        if self.training:
            return self._fold(dtype)
        if self._folded_cache is None:
            self._folded_cache = {}
        if dtype not in self._folded_cache:
            with torch.inference_mode(False), torch.no_grad():
                self._folded_cache[dtype] = self._fold(dtype)
        return self._folded_cache[dtype]

    def train(self, mode: bool = True):
        self._folded_cache = None
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._folded_cache = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded_cache = None
        super()._load_from_state_dict(*args, **kwargs)

    def _fused(self, x):
        """Kernel K2 on folded frames: (B,C,T,H,W) -> NHWC -> back."""
        b, c, t, h, w = x.shape
        frames = x.permute(0, 2, 3, 4, 1).reshape(b * t, h, w, c)
        y = fused_stage(frames, self._folded(x.dtype), stride=self.stride)
        return y.reshape(b, t, *y.shape[1:]).permute(0, 4, 1, 2, 3)

    def forward(self, slow, fast):
        if self.fused_slow:
            slow = self._fused(slow)
        else:
            for blk in self._blocks(0):
                slow = blk(slow)
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


class SlowFastBackbone(nn.Module):
    """Returns the 5 layer taps in ``dtype``; inputs slow (B,3,T/4,H,W),
    fast (B,3,T,H,W), cast to ``dtype`` on the way in."""

    def __init__(self, pallas_stages: bool = True, dtype=torch.float32,
                 fast_block: Optional[Sequence[int]] = None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.fast_block = check_fast_block(fast_block)
        w = 64
        self.s1 = VideoModelStem(w)
        self.s1_fuse = FuseFastToSlow(w // BETA_INV)
        slow_in, fast_in = w + 2 * w // BETA_INV, w // BETA_INV
        for si in range(4):
            fused = (pallas_stages and SLOW_TEMP_KERNELS[si + 1] == 1
                     and SPATIAL_STRIDES[si] == 1)
            self.add_module(f"s{si + 2}", ResStage(si, (slow_in, fast_in), fused))
            dim_out = w * 4 * 2 ** si
            if si < 3:
                self.add_module(f"s{si + 2}_fuse", FuseFastToSlow(dim_out // BETA_INV))
                slow_in = dim_out + 2 * dim_out // BETA_INV
            else:
                slow_in = dim_out
            fast_in = dim_out // BETA_INV

    def forward(self, slow, fast) -> List[torch.Tensor]:
        slow, fast = self.s1(slow.to(self.dtype), fast.to(self.dtype))
        slow, fast = self.s1_fuse(slow, fast)
        taps = [_pool_all(slow, fast)]  # 88
        for si in range(4):
            slow, fast = getattr(self, f"s{si + 2}")(slow, fast)
            if si < 3:
                slow, fast = getattr(self, f"s{si + 2}_fuse")(slow, fast)
            taps.append(_pool_all(slow, fast))  # 352 704 1408 2304
        return taps


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
                 fast_block: Optional[Sequence[int]] = None):
        super().__init__(pallas_stages=pallas_stages, dtype=dtype, fast_block=fast_block)
        self.eval()

    def forward(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """uint8 frames (B,T,H,W,3) -> the 5 taps (B, dim) in ``dtype``."""
        slow, fast = pack_pathways(normalize_frames(frames))
        to_ncdhw = (0, 4, 1, 2, 3)
        return SlowFastBackbone.forward(
            self, slow.permute(*to_ncdhw).contiguous(),
            fast.permute(*to_ncdhw).contiguous())


@register_model("slow_fast")  # reference model_types spelling
@register_model("slowfast")
class SlowFast(LayerSlowFast):
    """Final-layer-only variant (2304-d; reference slowfast.py:31-95)."""

    output_dims = 2304

    def forward(self, frames):
        return super().forward(frames)[-1]


def zero_init_final_bn(model: nn.Module) -> None:
    """ZERO_INIT_FINAL_BN: gamma 0 on every block's last BN, as the JAX
    package's flax init does (``slowfast.py:100-104``)."""
    for mod in model.modules():
        if isinstance(mod, BottleneckTransform):
            nn.init.zeros_(mod.c_bn.weight)


# -- flax <-> PySlowFast names --------------------------------------------------

def _flax_pairs():
    """(PySlowFast prefix, flax module path, is a conv) for every module."""
    out = []
    for pw, tag in ((0, "slow"), (1, "fast")):
        out.append((f"s1.pathway{pw}_stem.conv", (f"s1_{tag}", "conv"), True))
        out.append((f"s1.pathway{pw}_stem.bn", (f"s1_{tag}", "bn", "BatchNorm_0"),
                    False))
    for i in range(1, 5):
        out.append((f"s{i}_fuse.conv_f2s", (f"s{i}_fuse", "conv_f2s"), True))
        out.append((f"s{i}_fuse.bn", (f"s{i}_fuse", "bn", "BatchNorm_0"), False))
    for si in range(4):
        for bi in range(STAGE_BLOCKS[si]):
            for pw, tag in ((0, "slow"), (1, "fast")):
                t = f"s{si + 2}.pathway{pw}_res{bi}"
                f = (f"s{si + 2}_{tag}", f"block{bi}")
                for br in ("a", "b", "c"):
                    out.append((f"{t}.branch2.{br}", f + (f"branch2_{br}",), True))
                    bn = f + (f"branch2_{br}_bn",) + (() if br == "c" else ("BatchNorm_0",))
                    out.append((f"{t}.branch2.{br}_bn", bn, False))
                out.append((f"{t}.branch1", f + ("branch1",), True))
                out.append((f"{t}.branch1_bn", f + ("branch1_bn", "BatchNorm_0"),
                            False))
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

    for tkey, path, is_conv in _flax_pairs():
        node = _get(params, path)
        if node is None:  # blocks without a projection shortcut
            continue
        if is_conv:
            put(f"{tkey}.weight", np.asarray(node["kernel"]).transpose(4, 3, 0, 1, 2))
            continue
        st = _get(stats, path)
        put(f"{tkey}.weight", node["scale"])
        put(f"{tkey}.bias", node["bias"])
        put(f"{tkey}.running_mean", st["mean"])
        put(f"{tkey}.running_var", st["var"])
        sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


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
    ``num_batches_tracked``) are ignored; a projection shortcut is taken
    where the checkpoint has one."""
    params: Dict = {}
    stats: Dict = {}
    for tkey, path, is_conv in _flax_pairs():
        block = tkey.rsplit(".", 1)[0]
        if tkey.endswith(("branch1", "branch1_bn")) and f"{block}.branch1.weight" not in sd:
            continue
        if is_conv:
            _put(params, path, {"kernel": np.asarray(sd[f"{tkey}.weight"]).transpose(2, 3, 4, 1, 0)})
            continue
        _put(params, path, {"scale": np.asarray(sd[f"{tkey}.weight"]),
                            "bias": np.asarray(sd[f"{tkey}.bias"])})
        _put(stats, path, {"mean": np.asarray(sd[f"{tkey}.running_mean"]),
                           "var": np.asarray(sd[f"{tkey}.running_var"])})
    return {"params": params, "batch_stats": stats}
