"""Kernel K2: a kt=1 ResNet bottleneck stage on folded frames
(``csrc/bottleneck_stage.cu``, float32, and ``csrc/bottleneck_stage_bf16.cu``,
bfloat16).

The port of ``acav100m_tpu/ops/pallas/bottleneck_kernel.py::fused_stage``.
Frames are folded into the batch (N = batch * time, NHWC). BN is folded
into the conv weights (``fold_bn``). Each block computes

    a = relu(x . aw + ab);  b = relu(conv3x3_same(a, stride) + bb)
    y = relu(b . cw + cb + shortcut)

with a projection shortcut ``x[::s, ::s] . pw + pb`` where the block has
``pw`` (block 0) and the identity otherwise. The stride applies to block 0.

The stage runs in the dtype of x, in one of two forms, as the TPU kernel
does:

* float32: everything in float32. The CUDA kernel runs the block's three
  products on the tensor cores (``wgmma`` TF32) in 3xTF32: each fp32
  operand is split into two TF32 parts and each product issued three times,
  which keeps the result within a few 1e-6 of the fp32 plain version's max,
  where one TF32 product misses by about 4e-4 (TF32 off in the comparison).
  It takes the weights split and packed once (``pack_block_f32``: K-major
  planes of 4 channels, the TF32 big part and its TF32 remainder, cw and pw
  in passes of 128 columns) and streams them through its ring, since they
  do not fit in shared memory beside the activations.
* bfloat16: x, the weight matrices (``aw``, ``bw``, ``cw``, ``pw``), ``a``,
  ``b`` and the output in bf16; the biases in float32; every product and
  the 3x3's nine taps summed in float32; the projection shortcut kept in
  float32 after its bias and the identity shortcut widened to float32.
  ``a`` and ``b`` are rounded to bf16 after bias and ReLU, the output after
  the shortcut and ReLU (the TPU kernel's lines 91-101). It takes the
  weights packed by ``pack_block_bf16`` (K-major planes of 8 channels, cw
  and pw in passes of 256 columns) and keeps them resident in shared
  memory.

Both kernels are persistent (one CTA an SM), with x brought in by TMA
through an ``mbarrier`` ring and each product on ``wgmma`` with f32 sums;
the model caches each form's pack beside its folded weights.

``fused_stage`` launches the form's CUDA kernel once per block for CUDA
tensors and runs ``fused_stage_ref``, the plain PyTorch version, for CPU
tensors. The kernels take NHWC frames with input channels in multiples of
4 (float32) or 8 (bf16), 32 or 64 inner channels and output channels in
multiples of 32 (at most 768 in bf16, whose cw stays resident), at
stride 1 or 2; the float32 form's tiles are 16 x 16 output pixels (8 x 8
at stride 2), the bf16 form's 16 x 8 (8 x 8 at stride 2). They raise on
anything else. Each form counts its own launches in the tracing
counters ``k2_fp32.launches`` and ``k2_bf16.launches``, and
``k2.packs`` counts ``pack_block`` calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import tracing
from . import cuda_build

Tensor = torch.Tensor
_KEYS = ("aw", "ab", "bw", "bb", "cw", "cb")


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Inference BN -> (mul, add) per channel."""
    mul = scale / torch.sqrt(var + eps)
    return mul, bias - mean * mul


def _block_ref(h: Tensor, blk: Dict[str, Tensor], s: int) -> Tensor:
    """One block in the dtype of h: float32 products and sums on widened
    operands, rounded back to h's dtype where the TPU kernel rounds (a
    no-op in float32)."""
    dt = h.dtype
    hf = h.float()
    w = {k: v.float() for k, v in blk.items()}
    if "pw" in blk:
        shortcut = hf[:, ::s, ::s, :] @ w["pw"] + w["pb"]
    else:
        shortcut = hf
    a = torch.relu(hf @ w["aw"] + w["ab"]).to(dt).float()
    b = F.conv2d(a.permute(0, 3, 1, 2), w["bw"].permute(3, 2, 0, 1),
                 stride=s, padding=1).permute(0, 2, 3, 1)
    b = torch.relu(b + w["bb"]).to(dt).float()
    return torch.relu(b @ w["cw"] + w["cb"] + shortcut).to(dt)


def fused_stage_ref(x: Tensor, blocks: Sequence[Dict[str, Tensor]],
                    stride: int = 1) -> Tensor:
    """Plain PyTorch version: (N, H, W, Cin) -> (N, H/s, W/s, Cout), in the
    dtype of x (float32 or bfloat16)."""
    h = x
    for i, blk in enumerate(blocks):
        h = _block_ref(h, blk, stride if i == 0 else 1)
    return h


# output columns of a pass of the bf16 kernel's product c
PASS = 256
# output columns of a pass of the float32 kernel's product c (a warpgroup's)
PASS_F32 = 128
# the bf16 kernel keeps cw (inner x Cout) resident: at most 3 passes fit
BF16_MAX_COUT = 3 * PASS


def _pack_k(w: Tensor, kp: int, plane: int = 8) -> Tensor:
    """(K, N) -> (kp/plane, N, plane): K-major planes of ``plane`` input
    channels, rows past K zero."""
    k, n = w.shape
    w = F.pad(w, (0, 0, 0, kp - k))
    return w.reshape(kp // plane, plane, n).transpose(1, 2).contiguous()


def _pack_passes(w: Tensor, kp: int, width: int = PASS, plane: int = 8) -> Tensor:
    """(K, Cout) -> (P, kp/plane, width, plane): ``_pack_k`` of each pass of
    ``width`` output columns, columns past Cout zero."""
    k, cout = w.shape
    passes = -(-cout // width)
    w = F.pad(w, (0, passes * width - cout, 0, kp - k))
    return torch.stack([_pack_k(w[:, i * width:(i + 1) * width], kp, plane)
                        for i in range(passes)])


def pack_block_bf16(blk: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A block's bf16 weight matrices in the order the bf16 kernel's wgmma
    reads them from shared memory (``csrc/bottleneck_stage_bf16.cu``):
    ``aw`` (Cin rounded up to 16, zeros past Cin) and each of ``bw``'s nine
    taps as ``_pack_k``, ``cw`` and ``pw`` as ``_pack_passes``; and ``cb``,
    the float32 bias the kernel adds after product c, with the projection's
    ``pb`` added in."""
    cin, inner = blk["aw"].shape
    kp = -(-cin // 16) * 16
    out = {"aw": _pack_k(blk["aw"], kp),
           "bw": torch.stack([_pack_k(blk["bw"][dy, dx], inner)
                              for dy in range(3) for dx in range(3)]),
           "cw": _pack_passes(blk["cw"], inner)}
    out["cb"] = blk["cb"]
    if "pw" in blk:
        out["pw"] = _pack_passes(blk["pw"], kp)
        out["cb"] = blk["cb"] + blk["pb"]
    return out


def tf32_rna(v: Tensor) -> Tensor:
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to
    nearest, ties away from zero), for finite v: half a TF32 ulp added to
    the magnitude bits and the 13 bits TF32 drops cleared."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: Tensor):
    """(big, small): big = ``tf32_rna(w)``, small = ``tf32_rna(w - big)``;
    big + small is w to within about 2^-22 of its magnitude."""
    big = tf32_rna(w)
    return big, tf32_rna(w - big)


def pack_block_f32(blk: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A block's float32 weight matrices split and packed once, in the order
    the float32 kernel's wgmma reads them (``csrc/bottleneck_stage.cu``):
    each matrix as (2, ...), its TF32 big part (``tf32_split``), then its
    TF32 remainder, in K-major planes of 4 channels: ``aw`` (Cin rounded up
    to 16, zeros past Cin) and each of ``bw``'s nine taps as ``_pack_k``,
    ``cw`` and ``pw`` in passes of 128 output columns; and ``cb``, the
    float32 bias the kernel adds after product c, with the projection's
    ``pb`` added in, zero-padded to whole passes."""
    cin, inner = blk["aw"].shape
    cout = blk["cw"].shape[1]
    kp = -(-cin // 16) * 16
    mats = {"aw": _pack_k(blk["aw"], kp, 4),
            "bw": torch.stack([_pack_k(blk["bw"][dy, dx], inner, 4)
                               for dy in range(3) for dx in range(3)]),
            "cw": _pack_passes(blk["cw"], inner, PASS_F32, 4)}
    cb = blk["cb"]
    if "pw" in blk:
        mats["pw"] = _pack_passes(blk["pw"], kp, PASS_F32, 4)
        cb = cb + blk["pb"]
    out = {k: torch.stack(tf32_split(v)) for k, v in mats.items()}
    out["cb"] = F.pad(cb, (0, -(-cout // PASS_F32) * PASS_F32 - cout))
    return out


def pack_block(blk: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The pack of the kernel form that takes ``blk``'s weight matrices:
    ``pack_block_bf16`` for bfloat16, ``pack_block_f32`` for float32."""
    tracing.count("k2.packs")
    if blk["aw"].dtype == torch.bfloat16:
        return pack_block_bf16(blk)
    return pack_block_f32(blk)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# the launcher of each form: its source in csrc/ and its C entry point
_LAUNCHERS = {torch.float32: ("bottleneck_stage", "bottleneck_block"),
              torch.bfloat16: ("bottleneck_stage_bf16", "bottleneck_block_bf16")}


def bind(lib: ctypes.CDLL, entry: str = "bottleneck_block", tile: bool = False):
    """``lib``'s C launcher ``entry`` with its signature. Both forms take
    their packed weights and pick their own tile; ``tile`` True binds an
    older launcher (of either form) that takes the raw weights, pb among
    them, and the output tile (TH, TW) after the stride."""
    fn = getattr(lib, entry)
    weights = [ctypes.c_void_p] * (8 if tile else 7)
    tile = [ctypes.c_int] * 2 if tile else []
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + weights
                   + [ctypes.c_int] * 3 + tile + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind(dtype: torch.dtype):
    name, entry = _LAUNCHERS[dtype]
    return bind(cuda_build.load(name), entry)


def _check_block(blk: Dict[str, Tensor], cin: int, dev) -> torch.dtype:
    """Raise unless the kernel takes this block; returns its form's dtype.
    A block is all float32, or bf16 weight matrices with float32 biases."""
    inner = blk["aw"].shape[1]
    cout = blk["cw"].shape[1]
    shapes = {"aw": (cin, inner), "ab": (inner,), "bw": (3, 3, inner, inner),
              "bb": (inner,), "cw": (inner, cout), "cb": (cout,)}
    if "pw" in blk:
        shapes.update(pw=(cin, cout), pb=(cout,))
    elif cin != cout:
        raise ValueError(f"identity shortcut needs Cin == Cout, got {cin}, {cout}")
    dtype = blk["aw"].dtype
    if dtype not in _LAUNCHERS:
        raise ValueError(f"the kernel takes float32 or bfloat16 weights, got {dtype}")
    for key, shape in shapes.items():
        t = blk[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, expected {shape}")
        want = dtype if t.dim() > 1 else torch.float32
        if (t.device != dev or t.dtype != want or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{key} must be a contiguous, 16-byte aligned {want} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    align = 8 if dtype == torch.bfloat16 else 4  # 16-byte rows of x
    if cin % align or inner not in (32, 64) or cout % 32:
        raise ValueError(f"the kernel takes input channels in multiples of {align}, "
                         f"32 or 64 inner channels and output channels in multiples "
                         f"of 32, got {cin}, {inner}, {cout}")
    if dtype == torch.bfloat16 and cout > BF16_MAX_COUT:
        raise ValueError(f"K2's bf16 form keeps cw resident in shared memory: at most "
                         f"{BF16_MAX_COUT} output channels, got {cout}")
    return dtype


def _check_packed(w: Dict[str, Tensor], cin: int, inner: int, cout: int, dev,
                  dtype: torch.dtype) -> None:
    """Raise unless ``w`` is ``pack_block`` of a block of these widths in
    ``dtype``."""
    kp = -(-cin // 16) * 16
    if dtype == torch.bfloat16:
        passes = -(-cout // PASS)
        shapes = {"aw": (kp // 8, inner, 8), "bw": (9, inner // 8, inner, 8),
                  "cw": (passes, inner // 8, PASS, 8), "pw": (passes, kp // 8, PASS, 8),
                  "cb": (cout,)}
    else:
        passes = -(-cout // PASS_F32)
        shapes = {"aw": (2, kp // 4, inner, 4), "bw": (2, 9, inner // 4, inner, 4),
                  "cw": (2, passes, inner // 4, PASS_F32, 4),
                  "pw": (2, passes, kp // 4, PASS_F32, 4), "cb": (passes * PASS_F32,)}
    for key, t in w.items():
        want = torch.float32 if key == "cb" else dtype
        if (tuple(t.shape) != shapes[key] or t.dtype != want or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed {key} must be a contiguous {want} {shapes[key]} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(x: Tensor, blocks: Sequence[Dict[str, Tensor]], stride: int, counter: str,
            packed: Optional[Sequence[Dict[str, Tensor]]] = None) -> Tensor:
    """Launch the kernel of x's form once per block; the tracing counter
    ``counter`` counts them. Each form takes each block's ``pack_block``, from
    ``packed`` where the caller keeps it, else packed here."""
    fn = _bind(x.dtype)
    if packed is not None and len(packed) != len(blocks):
        raise ValueError(f"{len(packed)} packed blocks for {len(blocks)} blocks")
    h = x.contiguous()
    if h.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    s = stride
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        for i, blk in enumerate(blocks):
            n, hh, ww, cin = h.shape
            if hh % s or ww % s:
                raise ValueError(f"frame {hh}x{ww} not divisible by stride {s}")
            if _check_block(blk, cin, x.device) != x.dtype:
                raise ValueError(f"{x.dtype} frames need {x.dtype} weight matrices, "
                                 f"got {blk['aw'].dtype}")
            inner, cout = blk["aw"].shape[1], blk["cw"].shape[1]
            out = torch.empty((n, hh // s, ww // s, cout), device=x.device, dtype=x.dtype)
            w = packed[i] if packed is not None else pack_block(blk)
            _check_packed(w, cin, inner, cout, x.device, x.dtype)
            args = (w["aw"], blk["ab"], w["bw"], blk["bb"], w["cw"], w["cb"], w.get("pw"))
            err = fn(_ptr(h), n, hh, ww, cin, *(_ptr(t) for t in args),
                     inner, cout, s, _ptr(out), stream)
            cuda_build.check(err, _LAUNCHERS[x.dtype][1])
            tracing.count(counter)
            h, s = out, 1
    return h


def _device(x: Tensor) -> str:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def fused_stage(x: Tensor, blocks: Sequence[Dict[str, Tensor]],
                stride: int = 1,
                packed: Optional[Sequence[Dict[str, Tensor]]] = None) -> Tensor:
    """Run a kt=1 bottleneck stage over folded frames x (N, H, W, Cin) in
    x's dtype. CUDA tensors launch K2's form for that dtype once per block
    (bfloat16 through ``fused_stage_bf16``), on ``packed`` (each block's
    ``pack_block``) where given; CPU tensors take the plain version."""
    if _device(x) == "cpu":
        return fused_stage_ref(x, blocks, stride)
    if x.dtype == torch.bfloat16:
        return fused_stage_bf16(x, blocks, stride, packed)
    if x.dtype != torch.float32:
        raise ValueError(f"kernel K2 takes float32 or bfloat16, got {x.dtype}")
    return _launch(x, blocks, stride, "k2_fp32.launches", packed)


def fused_stage_bf16(x: Tensor, blocks: Sequence[Dict[str, Tensor]],
                     stride: int = 1,
                     packed: Optional[Sequence[Dict[str, Tensor]]] = None) -> Tensor:
    """K2's bfloat16 form: bf16 frames, bf16 weight matrices, float32
    biases. CUDA tensors launch ``csrc/bottleneck_stage_bf16.cu`` once per
    block, on ``packed`` (each block's ``pack_block_bf16``) where given;
    CPU tensors take the plain version."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K2's bf16 form takes bfloat16 frames, got {x.dtype}")
    if _device(x) == "cpu":
        return fused_stage_ref(x, blocks, stride)
    return _launch(x, blocks, stride, "k2_bf16.launches", packed)
