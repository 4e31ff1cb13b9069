"""Mini-batch SGD k-means over M stacked clusterings (PyTorch).

Port of ``acav100m_tpu/ops/kmeans.py`` — the reference's ``KMeans``
(``clustering/code/sgd_clustering.py:10-129``):

* centers init ``rand * 1e-5``;
* the first ``initial_rounds * k`` samples are assigned uniformly at random;
* distances ``-2*C@x^T + |x|^2 + |c|^2``; underused centers
  (``counts < (count/k)**p``) get distances divided by ``r``;
* update: one-hot counts/deltas,
  ``centers <- centers*(1 - counts*lr) + sum(lr*x)``, with the lr fallback
  ``lr = 0.5/max_count`` whenever ``lr*max_count >= 1``.

The M per-layer clusterings are stacked into one ``(M, K, Dmax)`` tensor
with feature dims zero-padded to ``Dmax`` (exact: padding adds nothing to
distances or deltas). After warmup ``train_step`` routes the assign and
accumulate through kernel K1 (``ops.kmeans_kernel``) when ``use_pallas``.

Across processes (``group=``, ``runtime.Group``) each rank steps on its own
rows and the per-step counts and deltas are summed over the ranks before
the update, as the JAX package's ``psum``s inside ``shard_map`` and the
reference's NCCL all-reduce (``sgd_clustering.py:113-127``) do; kernel K1
runs unchanged on each rank's local rows.

Random draws come from ``torch.Generator``s and are injectable: the JAX
package's ``jax.random`` draws cannot be reproduced in torch, so tests hand
the same draws to both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import Group, all_reduce_sum
from .kmeans_kernel import fused_assign_update

Tensor = torch.Tensor


@dataclasses.dataclass
class KMeansState:
    """Stacked state for M simultaneous clusterings.

    ``count`` (samples seen) lives on the host: it decides the warmup branch
    and the underuse threshold without a device round trip."""

    centers: Tensor  # (M, K, Dmax) f32
    counts: Tensor  # (M, K) f32
    count: int  # total samples seen
    fallback: Tensor  # () i32 — steps in which the lr fallback triggered
    d_mask: Tensor  # (M, Dmax) f32 — 1 on real feature dims
    # each clustering's real width, read off d_mask on the host (None: not
    # known, or d_mask is not a prefix mask)
    dims: Optional[Tuple[int, ...]] = None


def mask_dims(d_mask: np.ndarray) -> Optional[Tuple[int, ...]]:
    """The widths of a prefix mask (ones, then zeros in each row), else None."""
    d_mask = np.asarray(d_mask)
    dims = tuple(int(v) for v in (d_mask != 0).sum(-1))
    prefix = np.arange(d_mask.shape[-1])[None, :] < np.array(dims)[:, None]
    if min(dims, default=0) < 1 or not np.array_equal(d_mask != 0, prefix):
        return None
    return dims


def init_state(
    dims: Sequence[int],
    k: int,
    dmax: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    centers: Optional[Tensor] = None,
    device=None,
) -> KMeansState:
    """Initialize M clusterings with feature dims ``dims`` (padded to dmax).

    ``centers`` (M, K, Dmax), if given, replaces the ``rand * 1e-5`` draw
    (``sgd_clustering.py:24``) — it is still masked to the real dims."""
    dims = list(dims)
    m = len(dims)
    if dmax is None:
        dmax = max(dims)
    d_mask = np.zeros((m, dmax), dtype=np.float32)
    for i, d in enumerate(dims):
        d_mask[i, :d] = 1.0
    real = mask_dims(d_mask)
    d_mask = torch.as_tensor(d_mask, device=device)
    if centers is None:
        centers = torch.rand((m, k, dmax), generator=generator,
                             dtype=torch.float32) * 1e-5
    if not isinstance(centers, torch.Tensor):
        centers = torch.tensor(np.array(centers, dtype=np.float32))
    centers = centers.to(device=device, dtype=torch.float32)
    return KMeansState(
        centers=centers * d_mask[:, None, :],
        counts=torch.zeros((m, k), dtype=torch.float32, device=device),
        count=0,
        fallback=torch.zeros((), dtype=torch.int32, device=device),
        d_mask=d_mask,
        dims=real,
    )


def pad_features(batch: np.ndarray, dmax: int) -> np.ndarray:
    """(..., D) -> (..., dmax) zero-padded (host-side helper)."""
    d = batch.shape[-1]
    if d == dmax:
        return batch
    pad = [(0, 0)] * (batch.ndim - 1) + [(0, dmax - d)]
    return np.pad(batch, pad)


def _threshold(count: int, k: int, p: float) -> float:
    """``max(count/k, 0) ** p`` in float32, as the JAX package computes it."""
    c = torch.tensor(float(count), dtype=torch.float32) / k
    return float(torch.clamp(c, min=0.0) ** p)


def _distances(state: KMeansState, batch: Tensor) -> Tensor:
    """(M, B, Dmax) -> (M, K, B) squared euclidean distances."""
    cx = torch.matmul(state.centers, batch.transpose(1, 2))  # (M,K,B)
    x2 = (batch * batch).sum(-1)  # (M,B)
    c2 = (state.centers * state.centers).sum(-1)  # (M,K)
    return -2.0 * cx + x2[:, None, :] + c2[:, :, None]


def calc_best(
    state: KMeansState,
    batch: Tensor,
    rand: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    initial_rounds: int = 10,
    reinit: Tuple[float, float] = (0.7, 5.0),
) -> Tuple[Tensor, Tensor]:
    """Assign each sample to its best center -> (best (M,B) int64, mean
    min-distance (M,)).

    During warmup (``count < initial_rounds * k``) the argmin runs over
    ``rand`` (drawn from ``generator`` when not given), exactly like the
    reference's random assignment (``sgd_clustering.py:63-79``)."""
    m, k, _ = state.centers.shape
    p, r = reinit
    if state.count < initial_rounds * k:
        if rand is None:
            rand = torch.rand((m, k, batch.shape[1]), generator=generator)
        distances = rand.to(batch.device)
    else:
        real = _distances(state, batch)
        underused = state.counts < _threshold(state.count, k, p)
        distances = torch.where(underused[:, :, None], real / r, real)
    best = torch.argmin(distances, dim=1)  # (M,B), first index among ties
    min_d = torch.gather(distances, 1, best[:, None, :])[:, 0, :]
    return best, min_d.mean(-1)


def _segment_counts(best: Tensor, k: int) -> Tensor:
    return F.one_hot(best.long(), k).to(torch.float32).sum(1)


def _segment_deltas(best: Tensor, batch: Tensor, k: int) -> Tensor:
    onehot = F.one_hot(best.long(), k).to(batch.dtype)  # (M,B,K)
    return torch.bmm(onehot.transpose(1, 2), batch)


def train_step(
    state: KMeansState,
    batch: Tensor,
    lr: float,
    rand: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    initial_rounds: int = 10,
    reinit: Tuple[float, float] = (0.7, 5.0),
    use_pallas: bool = True,
    group: Optional[Group] = None,
) -> Tuple[KMeansState, Tensor]:
    """One mini-batch update. batch: (M, B_local, Dmax), zero past each
    clustering's width (as ``stack_batch`` pads it).

    With ``group``, counts and deltas are summed over its ranks before the
    lr fallback and the update (the JAX ``psum``s), so every rank computes
    the same new state, and ``count`` advances by the global batch,
    ``B_local`` times the world size (every rank steps on as many rows).
    The mean min-distance stays the rank's own. This is the counterpart of
    the JAX package's ``make_sharded_train_step``: the caller splits the
    batch, one process per card, instead of a sharding.

    ``use_pallas`` (the JAX package's key name) routes the post-warmup
    assign + accumulate through kernel K1 (``fused_assign_update``), which
    takes its plain version on CPU tensors. It passes the widths of
    ``state.dims``, so the kernel skips the padding: the centers are zero
    there by ``d_mask`` and the batch by the contract above. Warmup steps
    always take the random-assignment path. Returns (new_state, mean
    min-distance (M,))."""
    m, k, _ = state.centers.shape
    b_local = batch.shape[1]
    warmup = state.count < initial_rounds * k
    if use_pallas and not warmup:
        if reinit[1] != 5.0:
            raise ValueError("kernel K1 hardcodes the /5 underuse discount")
        threshold = _threshold(state.count, k, reinit[0])
        _, counts, deltas_raw, mean_dist = fused_assign_update(
            state.centers, state.counts, batch, threshold, dims=state.dims)
    else:
        best, mean_dist = calc_best(state, batch, rand, generator,
                                    initial_rounds, reinit)
        counts = _segment_counts(best, k)
        deltas_raw = _segment_deltas(best, batch, k)
    counts = all_reduce_sum(counts, group)
    deltas_raw = all_reduce_sum(deltas_raw, group)
    b_global = b_local * (group.world_size if group is not None else 1)

    # lr fallback (sgd_clustering.py:116-119): per-clustering max count
    max_count = counts.max(-1, keepdim=True).values  # (M, 1)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=counts.device)
    need_fallback = max_count * lr_t >= 1.0
    eff_lr = torch.where(need_fallback, 0.5 / torch.clamp(max_count, min=1.0), lr_t)
    fallback = state.fallback + need_fallback.any().to(torch.int32)

    centers = state.centers * (1.0 - counts * eff_lr)[:, :, None]
    centers = centers + deltas_raw * eff_lr[:, :, None]
    centers = centers * state.d_mask[:, None, :]
    new_state = KMeansState(
        centers=centers,
        counts=state.counts + counts,
        count=state.count + b_global,
        fallback=fallback,
        d_mask=state.d_mask,
        dims=state.dims,
    )
    return new_state, mean_dist


def assign_step(state: KMeansState, batch: Tensor,
                reinit: Tuple[float, float] = (0.7, 5.0)) -> Tensor:
    """Inference-time assignment (phase B): argmin with the underuse
    discount and no random branch (``run_clustering.py:180-272``)."""
    best, _ = calc_best(state, batch, initial_rounds=0, reinit=reinit)
    return best


def lr_schedule(epoch: int) -> float:
    """Reference schedule: ``0.1 ** (2 + epoch // 5)``."""
    return 0.1 ** (2 + epoch // 5)


def get_attrs(state: KMeansState, lr=None, initial_rounds=10, reinit=(0.7, 5.0)):
    """Checkpoint dict (numpy arrays) with the same keys and types as the JAX
    package's ``kmeans.get_attrs``, so centroid caches cross-load."""
    return {
        "centers": state.centers.detach().cpu().numpy(),
        "counts": state.counts.detach().cpu().numpy(),
        "count": int(state.count),
        "fallback": int(state.fallback),
        "d_mask": state.d_mask.detach().cpu().numpy(),
        "lr": lr,
        "initial_rounds": initial_rounds,
        "reinit": tuple(reinit),
        "sequential": False,
    }


def load_attrs(dt, device=None) -> KMeansState:
    d_mask = np.array(dt["d_mask"], np.float32)
    return KMeansState(
        centers=torch.tensor(np.array(dt["centers"], np.float32), device=device),
        counts=torch.tensor(np.array(dt["counts"], np.float32), device=device),
        count=int(dt["count"]),
        fallback=torch.tensor(int(dt.get("fallback", 0)), dtype=torch.int32,
                              device=device),
        d_mask=torch.tensor(d_mask, device=device),
        dims=mask_dims(d_mask),
    )
