"""Kernel K1: fused k-means assign + accumulate (``csrc/kmeans_assign_update.cu``).

The port of ``acav100m_tpu/ops/pallas/kmeans_kernel.py::fused_assign_update``.
For each clustering m of a stack of M: distances ``-2 x.c + |x|^2 + |c|^2``
to the K centers, divided by 5 for centers with ``counts < threshold``,
first-index argmin, one-hot counts, per-center sums of the assigned rows
(deltas), and the mean minimum distance.

``fused_assign_update`` launches the CUDA kernel for CUDA tensors and runs
``fused_assign_update_ref``, the plain PyTorch version of the same
function, for CPU tensors. It never falls back from one to the other. The
kernel computes the distances on the tensor cores in 3xTF32 (close to
fp32) and every sum in a fixed order, so two launches on the same inputs
give the same bytes. Given each clustering's real width (``dims``), it
skips the zero padding past it.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from . import cuda_build

Tensor = torch.Tensor
_KMAX = 256  # centers the kernel supports (KMAX in the source)
_MMAX = 64  # clusterings it supports (MMAX)


def discounted_distances(centers: Tensor, counts: Tensor, batch: Tensor,
                         threshold: float) -> Tensor:
    """(M,B,K) distances, divided by 5 for underused centers."""
    cx = torch.matmul(batch, centers.transpose(1, 2))  # (M,B,K)
    x2 = (batch * batch).sum(-1, keepdim=True)  # (M,B,1)
    c2 = (centers * centers).sum(-1)[:, None, :]  # (M,1,K)
    dist = -2.0 * cx + x2 + c2
    underused = (counts < threshold)[:, None, :]
    return torch.where(underused, dist / 5.0, dist)


def fused_assign_update_ref(
    centers: Tensor, counts: Tensor, batch: Tensor, threshold: float
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version: (best (M,B) i32, counts_add (M,K),
    deltas (M,K,D), min_dist_mean (M,))."""
    k = centers.shape[1]
    dist = discounted_distances(centers, counts, batch, threshold)
    best = torch.argmin(dist, dim=-1)  # first index among ties
    min_d = torch.gather(dist, -1, best[..., None])[..., 0]
    onehot = F.one_hot(best, k).to(batch.dtype)  # (M,B,K)
    counts_add = onehot.sum(1)
    deltas = torch.bmm(onehot.transpose(1, 2), batch)
    return best.to(torch.int32), counts_add, deltas, min_d.mean(-1)


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def bind(lib: ctypes.CDLL):
    """``lib``'s C launcher ``kmeans_assign_update`` and its workspace-size
    function, with their signatures."""
    fn = lib.kmeans_assign_update
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    workspace = lib.kmeans_assign_update_workspace
    workspace.argtypes = [ctypes.c_int] * 4
    workspace.restype = ctypes.c_size_t
    return fn, workspace


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(cuda_build.load("kmeans_assign_update"))


def launch(lib_fns, centers: Tensor, counts: Tensor, batch: Tensor, threshold: float,
           dims: Optional[Sequence[int]] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Allocate the outputs and the workspace and call the launcher
    ``lib_fns`` (from ``bind``) on the current stream; no checks of the
    inputs."""
    fn, workspace = lib_fns
    m, k, d = centers.shape
    b = batch.shape[1]
    if d % 4:  # the kernel stages rows in 16-byte groups: pad with zero columns
        d4 = d + 4 - d % 4
        out = launch(lib_fns, F.pad(centers, (0, d4 - d)), counts,
                     F.pad(batch, (0, d4 - d)), threshold, dims)
        return out[0], out[1], out[2][..., :d].contiguous(), out[3]
    dev = batch.device
    f32 = dict(device=dev, dtype=torch.float32)
    best = torch.empty((m, b), device=dev, dtype=torch.int32)
    counts_add = torch.empty((m, k), **f32)
    deltas = torch.empty((m, k, d), **f32)
    min_mean = torch.empty((m,), **f32)
    work = torch.empty((workspace(m, k, b, d),), device=dev, dtype=torch.uint8)
    widths = None if dims is None else (ctypes.c_int * m)(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(centers), _ptr(counts), _ptr(batch), float(threshold),
                 m, k, b, d, widths, _ptr(work), _ptr(best), _ptr(counts_add),
                 _ptr(deltas), _ptr(min_mean), ctypes.c_void_p(stream))
    cuda_build.check(err, "kmeans_assign_update")
    return best, counts_add, deltas, min_mean


def _check_dims(dims, m: int, d: int) -> Tuple[int, ...]:
    try:
        out = tuple(operator.index(v) for v in dims)
    except TypeError:
        raise ValueError(f"dims must be {m} ints, got {dims!r}") from None
    if len(out) != m or not all(1 <= v <= d for v in out):
        raise ValueError(f"dims must be {m} ints in [1, {d}], got {out}")
    return out


def fused_assign_update(
    centers: Tensor,  # (M,K,D) f32
    counts: Tensor,  # (M,K) f32
    batch: Tensor,  # (M,B,D) f32
    threshold: float,  # (count/k)**p, computed on the host
    dims: Optional[Sequence[int]] = None,  # (M,) real widths
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (best (M,B) i32, counts_add (M,K), deltas (M,K,D),
    min_dist_mean (M,)). CUDA tensors launch K1; CPU tensors take the plain
    version.

    ``dims``, if given, holds each clustering's real width; the caller
    guarantees that ``centers`` and ``batch`` are zero at and past it (as
    ``train_step``'s masked centers and zero-padded batches are). The
    kernel then skips those columns, with the results of the padded input;
    the plain version computes on the padded input as it is."""
    m, k, d = centers.shape
    if batch.dim() != 3 or batch.shape[0] != m or batch.shape[2] != d:
        raise ValueError(f"batch {tuple(batch.shape)} does not match centers "
                         f"{tuple(centers.shape)}")
    if tuple(counts.shape) != (m, k):
        raise ValueError(f"counts {tuple(counts.shape)} != {(m, k)}")
    if dims is not None:
        dims = _check_dims(dims, m, d)
    devices = {t.device for t in (centers, counts, batch)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if batch.device.type == "cpu":
        return fused_assign_update_ref(centers, counts, batch, float(threshold))
    if batch.device.type != "cuda":
        raise ValueError(f"unsupported device {batch.device}")
    for name, t in (("centers", centers), ("counts", counts), ("batch", batch)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
        if name != "counts" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k > _KMAX or m > _MMAX:
        raise ValueError(f"the kernel takes at most {_KMAX} centers and {_MMAX} "
                         f"clusterings, got K={k}, M={m}")
    out = launch(_bind(), centers, counts, batch, threshold, dims)
    tracing.count("k1.launches")
    return out
