"""Kernel K1: fused k-means assign + accumulate (``csrc/kmeans_assign_update.cu``).

The port of ``acav100m_tpu/ops/pallas/kmeans_kernel.py::fused_assign_update``.
For each clustering m of a stack of M: distances ``-2 x.c + |x|^2 + |c|^2``
to the K centers, divided by 5 for centers with ``counts < threshold``,
first-index argmin, one-hot counts, per-center sums of the assigned rows
(deltas), and the mean minimum distance.

``fused_assign_update`` launches the CUDA kernel for CUDA tensors and runs
``fused_assign_update_ref``, the plain PyTorch version of the same
function, for CPU tensors. It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

Tensor = torch.Tensor
_KMAX = 256  # centers the kernel supports (KMAX in the source)


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


@functools.lru_cache(maxsize=None)
def _bind():
    lib = cuda_build.load("kmeans_assign_update")
    fn = lib.kmeans_assign_update
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    tile = lib.kmeans_assign_update_tile
    tile.argtypes = [ctypes.c_int]
    tile.restype = ctypes.c_int
    return fn, tile


def fused_assign_update(
    centers: Tensor,  # (M,K,D) f32
    counts: Tensor,  # (M,K) f32
    batch: Tensor,  # (M,B,D) f32
    threshold: float,  # (count/k)**p, computed on the host
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (best (M,B) i32, counts_add (M,K), deltas (M,K,D),
    min_dist_mean (M,)). CUDA tensors launch K1; CPU tensors take the plain
    version."""
    m, k, d = centers.shape
    if batch.dim() != 3 or batch.shape[0] != m or batch.shape[2] != d:
        raise ValueError(f"batch {tuple(batch.shape)} does not match centers "
                         f"{tuple(centers.shape)}")
    if tuple(counts.shape) != (m, k):
        raise ValueError(f"counts {tuple(counts.shape)} != {(m, k)}")
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
    if k > _KMAX:
        raise ValueError(f"K={k} centers exceeds the kernel's limit {_KMAX}")
    b = batch.shape[1]
    fn, tile = _bind()
    tiles = -(-b // tile(k))
    dev = batch.device
    f32 = dict(device=dev, dtype=torch.float32)
    best = torch.empty((m, b), device=dev, dtype=torch.int32)
    part_counts = torch.empty((tiles, m, k), **f32)
    part_minsum = torch.empty((tiles, m), **f32)
    counts_add = torch.empty((m, k), **f32)
    deltas = torch.empty((m, k, d), **f32)
    min_mean = torch.empty((m,), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(centers), _ptr(counts), _ptr(batch), float(threshold),
                 m, k, b, d, _ptr(best), _ptr(part_counts), _ptr(part_minsum),
                 _ptr(counts_add), _ptr(deltas), _ptr(min_mean), ctypes.c_void_p(stream))
    cuda_build.check(err, "kmeans_assign_update")
    fused_assign_update.launches += 1
    return best, counts_add, deltas, min_mean


fused_assign_update.launches = 0
