"""The epilogue of a BN-folded convolution: ``csrc/conv_epilogue.cu``.

In inference a conv -> BN (-> ReLU) (-> + shortcut -> ReLU) unit of
SlowFast runs as one convolution with BN folded into its weights, on
channels-last (NDHWC) activations, then this one pass over its output, in
place:

    y = relu?((y + bias) + residual)

per channel ``bias`` (the folded BN's shift, float32) and, where given, a
residual of y's shape, dtype and layout. The sums are float32 in that order,
rounded once to y's dtype: ``conv_epilogue_ref``, the plain twin, gives the
same bits.

No TPU kernel computes this: XLA fuses conv, BN, ReLU and the residual add
for the JAX package. It is bound by its bytes (y, and the residual, read
once and y written once); the kernel moves them in 16-byte vectors.

``conv_epilogue`` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; either way it updates y in place and returns it. It takes y as
a 5-d (N, C, D, H, W) tensor whose memory is NDHWC (``channels_last_3d``),
float32 or bfloat16, with C a multiple of 8, and raises on anything else.
The kernel writes y without autograd knowing, so it also raises where a
gradient would flow through it. Its launches count in the tracing counter
``epilogue.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import tracing
from . import cuda_build

Tensor = torch.Tensor

CHANNELS = 8  # C a multiple of this: a 16-byte vector holds 8 bf16 or 4 float32 of one row
NAME = ENTRY = "conv_epilogue"


def conv_epilogue_ref(y: Tensor, bias: Tensor, residual: Optional[Tensor] = None,
                      relu: bool = True) -> Tensor:
    """The plain twin: y <- relu?((y + bias) + residual), in float32, rounded
    once to y's dtype; in place, returns y."""
    v = y.float() + bias.view(-1, *([1] * (y.dim() - 2)))
    if residual is not None:
        v = v + residual.float()
    if relu:
        v = torch.relu(v)
    return y.copy_(v)


def _check(y: Tensor, bias: Tensor, residual: Optional[Tensor]) -> None:
    if y.dim() != 5 or y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the epilogue takes a 5-d (N, C, D, H, W) float32 or bfloat16 "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    c = y.shape[1]
    if c % CHANNELS:
        raise ValueError(f"the epilogue takes C in multiples of {CHANNELS}, got {c}")
    if not y.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("y must be channels-last: its memory NDHWC, dense")
    if (tuple(bias.shape) != (c,) or bias.dtype != torch.float32 or bias.device != y.device
            or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({c},) tensor on {y.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if residual is not None:
        if (residual.shape != y.shape or residual.dtype != y.dtype
                or residual.device != y.device
                or not residual.is_contiguous(memory_format=torch.channels_last_3d)):
            raise ValueError(f"the residual must be a channels-last {y.dtype} "
                             f"{tuple(y.shape)} tensor on {y.device}, got {residual.dtype} "
                             f"{tuple(residual.shape)} on {residual.device}")
        if residual.data_ptr() == y.data_ptr():
            raise ValueError("the residual must not be y itself")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (y, bias, residual)):
        raise ValueError("the epilogue writes y in place and has no backward: call it "
                         "under torch.no_grad() or inference_mode")


@functools.lru_cache(maxsize=None)
def _bind():
    fn = getattr(cuda_build.load(NAME), ENTRY)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(y: Tensor, bias: Tensor, residual: Optional[Tensor], relu: bool) -> Tensor:
    if any(t.data_ptr() % 16 for t in (y, bias) + ((residual,) if residual is not None else ())):
        raise ValueError("y, bias and the residual must be 16-byte aligned")
    c = y.shape[1]
    fn = _bind()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(bias.data_ptr()),
                 ctypes.c_void_p(None if residual is None else residual.data_ptr()),
                 y.numel() // c, c, int(y.dtype == torch.bfloat16), int(relu),
                 ctypes.c_void_p(stream))
    cuda_build.check(err, ENTRY)
    tracing.count("epilogue.launches")
    return y


def conv_epilogue(y: Tensor, bias: Tensor, residual: Optional[Tensor] = None,
                  relu: bool = True) -> Tensor:
    """y <- relu?((y + bias) + residual) in place on a channels-last conv
    output; returns y. CUDA tensors launch the kernel, CPU tensors run the
    twin."""
    _check(y, bias, residual)
    if y.device.type == "cuda":
        return _launch(y, bias, residual, relu)
    if y.device.type != "cpu":
        raise ValueError(f"the epilogue runs on the CPU or CUDA, got {y.device}")
    return conv_epilogue_ref(y, bias, residual, relu)
