"""Kernel K2: a kt=1 ResNet bottleneck stage on folded frames
(``csrc/bottleneck_stage.cu``).

The port of ``acav100m_tpu/ops/pallas/bottleneck_kernel.py::fused_stage``.
Frames are folded into the batch (N = batch * time, NHWC). BN is folded
into the conv weights (``fold_bn``). Each block computes

    a = relu(x . aw + ab);  b = relu(conv3x3_same(a, stride) + bb)
    y = relu(b . cw + cb + shortcut)

with a projection shortcut ``x[::s, ::s] . pw + pb`` where the block has
``pw`` (block 0) and the identity otherwise. The stride applies to block 0.

``fused_stage`` launches the CUDA kernel once per block for CUDA tensors
and runs ``fused_stage_ref``, the plain PyTorch version, for CPU tensors.
The kernel runs the block's three products on the tensor cores
(``mma.sync`` TF32) in 3xTF32: each fp32 operand is split into two TF32
parts and each product issued three times, which keeps the result within
a few 1e-6 of the fp32 plain version's max, where one TF32 product misses
by about 4e-4 (TF32 off in the comparison). It takes float32 NHWC frames
with input channels in multiples of 4, 32 or 64 inner channels and output
channels in multiples of 32; each CTA owns an 8 x 16 output tile (4 x 8 at
stride 2). It raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from . import cuda_build

Tensor = torch.Tensor
_KEYS = ("aw", "ab", "bw", "bb", "cw", "cb")


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Inference BN -> (mul, add) per channel."""
    mul = scale / torch.sqrt(var + eps)
    return mul, bias - mean * mul


def _block_ref(h: Tensor, blk: Dict[str, Tensor], s: int) -> Tensor:
    if "pw" in blk:
        shortcut = h[:, ::s, ::s, :] @ blk["pw"] + blk["pb"]
    else:
        shortcut = h
    a = torch.relu(h @ blk["aw"] + blk["ab"])
    b = F.conv2d(a.permute(0, 3, 1, 2), blk["bw"].permute(3, 2, 0, 1),
                 stride=s, padding=1).permute(0, 2, 3, 1)
    b = torch.relu(b + blk["bb"])
    return torch.relu(b @ blk["cw"] + blk["cb"] + shortcut)


def fused_stage_ref(x: Tensor, blocks: Sequence[Dict[str, Tensor]],
                    stride: int = 1) -> Tensor:
    """Plain PyTorch version: (N, H, W, Cin) -> (N, H/s, W/s, Cout)."""
    h = x
    for i, blk in enumerate(blocks):
        h = _block_ref(h, blk, stride if i == 0 else 1)
    return h


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def bind(lib: ctypes.CDLL):
    """``lib``'s C launcher ``bottleneck_block`` with its signature."""
    fn = lib.bottleneck_block
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(cuda_build.load("bottleneck_stage"))


def _check_block(blk: Dict[str, Tensor], cin: int, dev) -> None:
    inner = blk["aw"].shape[1]
    cout = blk["cw"].shape[1]
    shapes = {"aw": (cin, inner), "ab": (inner,), "bw": (3, 3, inner, inner),
              "bb": (inner,), "cw": (inner, cout), "cb": (cout,)}
    if "pw" in blk:
        shapes.update(pw=(cin, cout), pb=(cout,))
    elif cin != cout:
        raise ValueError(f"identity shortcut needs Cin == Cout, got {cin}, {cout}")
    for key, shape in shapes.items():
        t = blk[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, expected {shape}")
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{key} must be a contiguous, 16-byte aligned float32 "
                             f"tensor on {dev}")
    if cin % 4 or inner not in (32, 64) or cout % 32:
        raise ValueError(f"the kernel takes input channels in multiples of 4, 32 or "
                         f"64 inner channels and output channels in multiples of 32, "
                         f"got {cin}, {inner}, {cout}")


def fused_stage(x: Tensor, blocks: Sequence[Dict[str, Tensor]],
                stride: int = 1) -> Tensor:
    """Run a kt=1 bottleneck stage over folded frames x (N, H, W, Cin).
    CUDA tensors launch K2 once per block; CPU tensors take the plain
    version."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_stage_ref(x, blocks, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"kernel K2 takes float32, got {x.dtype}")
    fn = _bind()
    h = x.contiguous()
    if h.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    s = stride
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        for blk in blocks:
            n, hh, ww, cin = h.shape
            if hh % s or ww % s:
                raise ValueError(f"frame {hh}x{ww} not divisible by stride {s}")
            _check_block(blk, cin, x.device)
            inner, cout = blk["aw"].shape[1], blk["cw"].shape[1]
            th, tw = (8, 16) if s == 1 else (4, 8)  # output tile; pixels a multiple of 32
            out = torch.empty((n, hh // s, ww // s, cout), device=x.device,
                              dtype=torch.float32)
            err = fn(_ptr(h), n, hh, ww, cin,
                     *(_ptr(blk[k]) for k in _KEYS),
                     _ptr(blk.get("pw")), _ptr(blk.get("pb")),
                     inner, cout, s, th, tw, _ptr(out), stream)
            cuda_build.check(err, "bottleneck_block")
            fused_stage.launches += 1
            h, s = out, 1
    return h


fused_stage.launches = 0
