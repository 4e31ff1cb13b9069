"""The core of the non-local block's ``dot_product`` instantiation:
``csrc/nonlocal_core_bf16.cu``, bfloat16.

PySlowFast's non-local block (``slowfast/models/nonlocal_helper.py``,
Wang et al. 2018) computes, per clip, from theta (Ci, Nq) and the pooled
phi and g (Ci, Nk),

    y = g . (theta^T phi / Nk)^T        (Ci, Nq)

which it evaluates in the published order: S = theta^T phi (Nq x Nk),
then S g^T. With ``dot_product`` S is only scaled, so the same function
is ``y = A^T theta`` with ``A^T = g phi^T / Nk`` (Ci x Ci): at ``res3``'s
shapes (Nq 8192, Nk 2048, Ci 256) 13 times fewer operations, and nothing
of size Nq x Nk exists. The kernel and its plain twin take that order.

No TPU kernel computes this: the JAX package has no non-local block. The
kernel is the port's own kernel of the block: one launch, the order and its
two bf16 roundings fixed in its code. At the main path's shapes it is bound
by its bytes (theta, phi and g read once, y written once: 0.335 GB a batch
of 32 at ``res3``, 0.168 GB at ``res4``, against 43 us of the cheaper
order's products at 989 TFLOP/s bf16). It runs slower than two cuBLAS bf16
``bmm`` calls in the same order (on an H100 80GB HBM3 at 700 W, 0.166 /
0.141 ms against 0.136 / 0.100 ms at ``res3`` / ``res4``, batch 32): its
tiles of y re-read ``A^T`` and theta from the L2, and the ``A^T`` tiles'
long loops over Nk open the launch on half its CTAs; larger ``wgmma``
tiles fed by TMA are the way under the library's time.

bfloat16: theta, phi, g and y in bf16; ``A^T`` summed in float32 over
Nk, scaled by 1/Nk in float32 and rounded to bf16 (the kernel keeps it in a
Ci x Ci workspace in device memory); y summed in float32 over Ci and
rounded to bf16. One launch a block: a persistent grid whose CTAs take
128 x 128 output tiles in order from a ticket, first every tile of
``A^T``, then every tile of y, a tile of clip n's y waiting until all of
clip n's ``A^T`` tiles are written (a count a clip in the workspace,
set to zero before the launch). Products on ``mma.sync``
m16n8k16 bf16 with float32 sums, operands by ``cp.async`` through a
3-stage ring in shared memory, each tile written out through shared memory
in rows of 16 bytes.

``nonlocal_core`` launches the kernel for bf16 CUDA tensors and runs
``nonlocal_core_ref``, the plain twin, for CPU tensors of either dtype. A
float32 CUDA tensor (not on a benchmarked path) runs the twin's float32
products on the card: cuBLAS in float32 while
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default.
The kernel takes Ci in multiples of 128 (the model's widths are) and
raises on anything else. It takes any Nq and Nk: partial tiles are
zero-filled in the kernel and stored masked. Where Nq or Nk is not a
multiple of 8 (its rows would not be rows of 16-byte chunks), the wrapper
pads theta, or phi and g, with zero columns up to one, a copy of each
(zero keys add nothing to ``A^T``, which is scaled by the true 1/Nk), and
returns y's first Nq columns. Its launches count in the tracing counter
``nln_bf16.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from . import cuda_build

Tensor = torch.Tensor

TILE = 128  # the kernel's output tile (rows and columns)
CHUNK = 8  # bf16 elements in the kernel's 16-byte loads and stores
NAME, ENTRY = "nonlocal_core_bf16", "nonlocal_core_bf16"


def nonlocal_core_ref(theta: Tensor, phi: Tensor, g: Tensor) -> Tensor:
    """The plain twin: (N, Ci, Nq), (N, Ci, Nk), (N, Ci, Nk) -> y (N, Ci,
    Nq) in theta's dtype, as ``A^T = g phi^T / Nk`` then ``y = A^T theta``,
    each product in float32 on widened operands, ``A^T`` and y rounded to
    the dtype (a no-op in float32)."""
    dt = theta.dtype
    nk = phi.shape[-1]
    at = torch.bmm(g.float(), phi.float().transpose(1, 2)) * (1.0 / nk)
    at = at.to(dt).float()
    return torch.bmm(at, theta.float()).to(dt)


def _check(theta: Tensor, phi: Tensor, g: Tensor) -> Tuple[int, int, int, int]:
    if theta.dim() != 3 or phi.dim() != 3 or g.dim() != 3:
        raise ValueError("theta, phi and g must be (N, Ci, L)")
    n, ci, nq = theta.shape
    nk = phi.shape[-1]
    if tuple(phi.shape) != (n, ci, nk) or tuple(g.shape) != (n, ci, nk):
        raise ValueError(f"phi {tuple(phi.shape)} and g {tuple(g.shape)} must both be "
                         f"({n}, {ci}, Nk) beside theta {tuple(theta.shape)}")
    if len({theta.dtype, phi.dtype, g.dtype}) != 1 or len(
            {theta.device, phi.device, g.device}) != 1:
        raise ValueError("theta, phi and g must share a dtype and a device")
    return n, ci, nq, nk


@functools.lru_cache(maxsize=None)
def _bind():
    fn = getattr(cuda_build.load(NAME), ENTRY)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _launch(theta: Tensor, phi: Tensor, g: Tensor) -> Tensor:
    n, ci, nq, nk = _check(theta, phi, g)
    if theta.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {theta.dtype}")
    if ci % TILE:
        raise ValueError(f"the kernel takes Ci in multiples of {TILE}, got Ci {ci}")
    nq_pad, nk_pad = -nq % CHUNK, -nk % CHUNK
    theta = F.pad(theta, (0, nq_pad)) if nq_pad else theta.contiguous()
    phi, g = ((F.pad(phi, (0, nk_pad)), F.pad(g, (0, nk_pad))) if nk_pad
              else (phi.contiguous(), g.contiguous()))
    # 16-byte rows need a 16-byte start (a view's offset may not give one)
    theta, phi, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (theta, phi, g))
    fn = _bind()
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        # A^T (n, ci, ci) in bf16, then a count a clip and the ticket
        work = torch.empty(n * ci * ci * 2 + 4 * (n + 1), dtype=torch.uint8,
                           device=theta.device)
        y = torch.empty((n, ci, nq + nq_pad), dtype=torch.bfloat16, device=theta.device)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (theta, phi, g, work)),
                 n, ci, nq + nq_pad, nk + nk_pad, nk, ctypes.c_void_p(y.data_ptr()),
                 ctypes.c_void_p(stream))
    cuda_build.check(err, ENTRY)
    tracing.count("nln_bf16.launches")
    return y[..., :nq] if nq_pad else y


def nonlocal_core(theta: Tensor, phi: Tensor, g: Tensor) -> Tensor:
    """``dot_product``'s core, y = g (theta^T phi / Nk)^T, (N, Ci, Nq) in
    theta's dtype: bf16 CUDA tensors launch the kernel, CPU tensors and
    float32 CUDA tensors run the plain twin."""
    _check(theta, phi, g)
    if theta.device.type == "cuda" and theta.dtype == torch.bfloat16:
        return _launch(theta, phi, g)
    if theta.device.type not in ("cpu", "cuda") or theta.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"nonlocal_core takes float32 or bfloat16 on the CPU or CUDA, "
                         f"got {theta.dtype} on {theta.device}")
    return nonlocal_core_ref(theta, phi, g)
