"""Post-training int8 quantization of the SlowFast stages (PyTorch).

Port of ``acav100m_tpu/models/quant.py`` with the same numerics:

* **Weights**: symmetric per-output-channel int8, ``amax`` over every axis
  but the output channel (dims 1..4 of torch's OIDHW kernel) and
  ``scale = max(amax, 1e-12) / 127``.
* **Activations**: symmetric per-tensor int8 against static scales that a
  calibration pass learns (running abs-max observers, ``MODES``):
  ``clip(round(x.float() / scale), -127, 127)``, dividing as the JAX
  package does (``torch.round`` rounds half to even, as ``jnp.round``).
* **Convs** accumulate in exact int32 and dequantize as
  ``y.float() * (sx * sw)``, then cast to the compute dtype.

The JAX package runs its int8 conv as an XLA convolution with int32
accumulation (``lax.conv_general_dilated(..., preferred_element_type=
int32)``), not as a Pallas kernel. The port lowers it to one int8 matrix
product, ``torch._int_mm``, over an explicit im2col of the channels-last
activations: cuBLASLt's int8 tensor-core GEMM on the card, an exact int32
product on the CPU. Every K (Cin * kt * kh * kw) and N (Cout) of SlowFast
8x8 R50 is a multiple of 8, as cuBLASLt asks; a shape it refuses raises.
No float convolution of the int8 values is used: float32 sums are exact
only below 2**24, and the ``s4``/``s5`` products reach K = 3840-6144.

The product's rows come out channels-last, so a quantized stage keeps its
activations in the ``channels_last_3d`` layout (an NCDHW view of NDHWC
memory): the next im2col reads them without a transpose.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Quantization modes threaded through the backbone call:
#   'none'  - fp path, the observers untouched
#   'calib' - fp path; the abs-max observers keep running maxima
#   'int8'  - the quantized path on the frozen observer scales
MODES = ("none", "calib", "int8")


def weight_qparams(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a conv weight (Cout, ...):
    (int8 weight, float32 scale (Cout,)) with weight ~ q * scale."""
    w = weight.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    shape = (-1,) + (1,) * (w.dim() - 1)
    q = torch.clamp(torch.round(w / scale.view(shape)), -127, 127).to(torch.int8)
    return q, scale


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Pointwise fp -> int8 with a static per-tensor scale."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """An observer's frozen scale: max(amax, 1e-12) / 127."""
    return torch.clamp(amax, min=1e-12) / 127.0


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """int8 (Cout, Cin, kt, kh, kw) -> (Cout, kt*kh*kw*Cin), taps major and
    channels minor, the column order of ``im2col``."""
    return wq.permute(0, 2, 3, 4, 1).reshape(wq.shape[0], -1).contiguous()


def im2col(xq: torch.Tensor, ksize: Sequence[int], stride: Sequence[int],
           padding: Sequence[int]) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """int8 NCDHW -> ((N*To*Ho*Wo, taps*Cin) int8 rows, (N, To, Ho, Wo)):
    each output position's receptive field, zero-padded, taps major."""
    n, c, t, h, w = xq.shape
    x = xq.permute(0, 2, 3, 4, 1)  # NDHWC; a view for channels_last_3d input
    if any(padding):
        pt, ph, pw = padding
        x = torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph, pt, pt))
    kt, kh, kw = ksize
    st, sh, sw = stride
    to = (t + 2 * padding[0] - kt) // st + 1
    ho = (h + 2 * padding[1] - kh) // sh + 1
    wo = (w + 2 * padding[2] - kw) // sw + 1
    taps = [x[:, a:a + (to - 1) * st + 1:st, b:b + (ho - 1) * sh + 1:sh,
              d:d + (wo - 1) * sw + 1:sw]
            for a in range(kt) for b in range(kh) for d in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.stack(taps, dim=4)
    return cols.reshape(n * to * ho * wo, -1), (n, to, ho, wo)


def conv3d_int8(xq: torch.Tensor, wmat: torch.Tensor, ksize: Sequence[int],
                stride: Sequence[int], padding: Sequence[int]):
    """int8 NCDHW conv with exact int32 sums -> (N*To*Ho*Wo, Cout) int32
    rows and the output's (N, To, Ho, Wo): the im2col rows times the
    (Cout, K) weight matrix, transposed, in ``torch._int_mm`` (cuBLASLt on
    the card, which takes M > 16 and K, Cout multiples of 8, and raises on
    anything else)."""
    cols, shape = im2col(xq, ksize, stride, padding)
    return torch._int_mm(cols, wmat.t()), shape


def rows_to_ncdhw(rows: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """(N*To*Ho*Wo, C) rows -> the NCDHW view of their NDHWC memory."""
    return rows.view(*shape, rows.shape[-1]).permute(0, 4, 1, 2, 3)


def qconv(xq: torch.Tensor, sx: torch.Tensor, wmat: torch.Tensor, sw: torch.Tensor,
          conv: torch.nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    """int8 conv with ``conv``'s geometry, dequantized as
    ``y.float() * (sx * sw)`` and cast to ``dtype``; NCDHW out."""
    y, shape = conv3d_int8(xq, wmat, conv.kernel_size, conv.stride, conv.padding)
    return rows_to_ncdhw((y.float() * (sx * sw)).to(dtype), shape)
