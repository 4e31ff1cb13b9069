"""Pairwise mutual information over cluster assignments (PyTorch).

Port of the parts of ``acav100m_tpu/ops/mi.py`` that stage 6 runs: the
eps-filled contingency cache (reference ``measures/mi.py:32-39``), the
incremental O(W*P) MI score (``EfficientMemMI``, ``mi.py:284-412``) and the
batched greedy selector (``EfficientBatchMI``, ``measures/batch.py``).

    cache: N (P,C,C) eps-filled, a = N.sum(1) (P,C), b = N.sum(2) (P,C),
           n = a.sum(-1) (P)

Cell reads are gathers; they return the same values as the JAX package's
one-hot einsums. Winners are folded into the cache by first summing their
(exactly integer) one-hot contributions and then adding the sum to the
cache, the JAX package's order of operations, so caches agree bit for bit.
Top-k breaks ties by the lowest index (a stable descending sort), like
``lax.top_k``; ``torch.topk`` orders ties arbitrarily.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
EPS = float(np.finfo("float64").eps)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def init_cache(num_pairs: int, ncentroids: int, dtype=torch.float32,
               device=None) -> Dict[str, Tensor]:
    """eps-filled contingency cache (reference mi.py:32-39)."""
    n_mat = torch.full((num_pairs, ncentroids, ncentroids), EPS, dtype=dtype,
                       device=device)
    a = n_mat.sum(1)
    b = n_mat.sum(2)
    n = a.sum(-1)
    return {"N": n_mat, "a": a, "b": b, "n": n}


def pair_assignments(assignments: np.ndarray,
                     combinations: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(V, D) assignments + P pairs -> (V, P, 2) pair coordinates."""
    comb = np.asarray(list(combinations), dtype=np.int64)  # (P, 2)
    return np.stack(
        [assignments[:, comb[:, 0]], assignments[:, comb[:, 1]]], axis=-1
    ).astype(np.int32)


def _onehots(pairs: Tensor, ncentroids: int, dtype=torch.float32):
    """(..., P, 2) int -> two (..., P, C) one-hots."""
    p1 = torch.nn.functional.one_hot(pairs[..., 0].long(), ncentroids).to(dtype)
    p2 = torch.nn.functional.one_hot(pairs[..., 1].long(), ncentroids).to(dtype)
    return p1, p2


def add_candidates_to_cache(cache: Dict, pairs: Tensor, ncentroids: int,
                            weights: Optional[Tensor] = None) -> Dict:
    """Fold S samples (pairs (S,P,2)) into the cache (reference
    mi.py:127-148); ``weights`` (S,) scale each sample (pads get 0)."""
    dtype = cache["N"].dtype
    p1, p2 = _onehots(pairs, ncentroids, dtype)  # (S,P,C)
    if weights is not None:
        w = weights.to(dtype)[:, None, None]
        p1w, p2w = p1 * w, p2 * w
    else:
        p1w, p2w = p1, p2
    # sum over samples of the (P,C,C) one-hot outer products; N[p, i, j]
    # counts samples with first view i and second view j
    d_n = torch.einsum("spa,spb->pab", p1w, p2)
    return {
        "N": cache["N"] + d_n,
        "a": cache["a"] + p2w.sum(0),
        "b": cache["b"] + p1w.sum(0),
        "n": cache["n"] + (p1w.sum(-1).sum(0) if weights is not None
                           else torch.full_like(cache["n"], float(pairs.shape[0]))),
    }


def nlogn(x: Tensor) -> Tensor:
    return x * torch.log(x)


def mem_stats(cache: Dict) -> Dict[str, Tensor]:
    """Per-pair sums Sum(N log N), Sum(a log a), Sum(b log b)
    (reference mi.py:297-308)."""
    return {
        "NlogN": nlogn(cache["N"]).sum(dim=(-1, -2)),
        "aloga": nlogn(cache["a"]).sum(-1),
        "blogb": nlogn(cache["b"]).sum(-1),
    }


def _pair_mean(scores: Tensor, pair_weights=None) -> Tensor:
    if pair_weights is None:
        return scores.mean(-1)
    w = torch.as_tensor(pair_weights, dtype=scores.dtype, device=scores.device)
    return (scores * w).sum(-1) / torch.clamp(w.sum(), min=EPS)


def score_candidates_mem(cache: Dict, stats: Dict, pairs: Tensor,
                         ncentroids: int, pair_weights=None) -> Tensor:
    """Incremental MI score of W candidates (pairs (W,P,2)) -> (W,).

    Adding one sample increments one cell and one margin entry per pair, so
    the nlogn sums update by ``-nlogn(x) + nlogn(x+1)`` (reference
    mi.py:322-381). NB margins: ``a`` sums over the first cluster axis, so
    it is indexed by the second view (p2), and ``b`` by the first (p1)."""
    i1 = pairs[..., 0].long()  # (W,P)
    i2 = pairs[..., 1].long()
    pidx = torch.arange(pairs.shape[1], device=pairs.device)[None, :]
    n_at = cache["N"][pidx, i1, i2]
    a_at = cache["a"][pidx, i2]
    b_at = cache["b"][pidx, i1]
    new_nlogn = stats["NlogN"][None] - nlogn(n_at) + nlogn(n_at + 1)
    new_aloga = stats["aloga"][None] - nlogn(a_at) + nlogn(a_at + 1)
    new_blogb = stats["blogb"][None] - nlogn(b_at) + nlogn(b_at + 1)
    n_new = (cache["n"] + 1)[None]
    scores = new_nlogn / n_new - new_aloga / n_new - new_blogb / n_new + torch.log(n_new)
    return _pair_mean(scores, pair_weights)


def stable_top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k values and indices, ties to the lowest index (``lax.top_k``)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


class BatchGreedySelector:
    """Greedy batched MI maximization (reference batch.py:10-260).

    Per iteration: take the next ``batch_size`` candidates from a shuffled
    pool, score each as if added alone, select the ``selection_size`` best,
    fold them into the cache; unselected candidates return to the back of
    the pool when ``keep_unselected``. Pool bookkeeping is host numpy with
    the caller's ``RandomState``; scoring runs on ``device``. The batch has
    a static size B: a short tail batch is padded and its pads scored -inf
    and folded with weight 0, as in the JAX package.
    """

    def __init__(
        self,
        assignments: np.ndarray,  # (V, D) ints
        combinations: Sequence[Tuple[int, int]],
        ncentroids: int,
        batch_size: int = 20,
        selection_size: int = 4,
        keep_unselected: bool = True,
        seed: Optional[int] = None,
        rng: Optional[np.random.RandomState] = None,
        pair_weights=None,
        dtype="float32",
        device=None,
    ):
        self.assignments = np.asarray(assignments)
        self.combinations = list(combinations)
        self.C = int(ncentroids)
        self.B = int(batch_size)
        self.k = int(selection_size)
        self.keep_unselected = keep_unselected
        self.pair_weights = (
            np.asarray(pair_weights, np.float32) if pair_weights is not None else None
        )
        self.rng = rng if rng is not None else np.random.RandomState(seed)
        self.dtype = resolve_dtype(dtype)
        self.device = torch.device(device or "cpu")
        pairs_np = pair_assignments(self.assignments, self.combinations)
        self.pairs_all = torch.as_tensor(pairs_np, device=self.device)  # (V,P,2)
        self.cache = init_cache(len(self.combinations), self.C, self.dtype,
                                self.device)
        self.stats = mem_stats(self.cache)
        self.candidate_ids = np.arange(self.assignments.shape[0], dtype=np.int64)

    def _step(self, batch_ids: Tensor, valid_mask: Tensor):
        pairs = self.pairs_all[batch_ids]  # (B,P,2)
        scores = score_candidates_mem(self.cache, self.stats, pairs, self.C,
                                      pair_weights=self.pair_weights)
        scores = torch.where(valid_mask, scores,
                             torch.tensor(-math.inf, dtype=scores.dtype,
                                          device=scores.device))
        top_scores, top_idx = stable_top_k(scores, self.k)
        winner_valid = valid_mask[top_idx]
        self.cache = add_candidates_to_cache(self.cache, pairs[top_idx], self.C,
                                             weights=winner_valid)
        self.stats = mem_stats(self.cache)
        return top_idx, top_scores

    def shuffle_candidates(self):
        self.rng.shuffle(self.candidate_ids)

    def add_samples(self, ids: Sequence[int]):
        """Seed the cache with start indices (reference batch.py:190-193)."""
        ids = np.asarray(list(ids), dtype=np.int64)
        if ids.size == 0:
            return
        pairs = self.pairs_all[torch.as_tensor(ids, device=self.device)]
        self.cache = add_candidates_to_cache(self.cache, pairs, self.C)
        self.stats = mem_stats(self.cache)
        self.candidate_ids = self.candidate_ids[~np.isin(self.candidate_ids, ids)]

    def modify_k(self, subset_size: int) -> int:
        """Grow k when B*S/V > k so the loop can terminate
        (reference batch.py:173-188)."""
        v = self.assignments.shape[0]
        term = self.B * subset_size / v
        if self.k < term and not self.keep_unselected:
            self.k = math.ceil(term)
        return self.k

    def run_greedy(self, subset_size: int, start_indices: Sequence[int] = ()):
        """Select ``subset_size`` ids. Returns (S, GAIN, timelapse, LOOKUPS)
        like the reference (batch.py:202-260)."""
        import time

        selected: List[int] = []
        gains: List[float] = []
        timelapse: List[float] = []
        lookups: List[int] = []
        self.modify_k(subset_size)
        self.add_samples(list(start_indices))
        while len(selected) < subset_size:
            t0 = time.time()
            self.shuffle_candidates()
            b = min(self.B, len(self.candidate_ids))
            if b == 0:
                break
            batch = self.candidate_ids[:b]
            if b < self.B:  # pad to the static size; pads are masked
                batch_dev = np.concatenate([batch, np.full(self.B - b, batch[0])])
            else:
                batch_dev = batch
            valid_mask = np.arange(self.B) < b
            top_idx, top_scores = self._step(
                torch.as_tensor(batch_dev, device=self.device),
                torch.as_tensor(valid_mask, device=self.device))
            top_idx = top_idx.cpu().numpy()
            top_scores = top_scores.cpu().numpy()
            if b < self.B:
                keep = top_idx < b
                top_idx, top_scores = top_idx[keep], top_scores[keep]
            winner_ids = batch[top_idx]
            selected += winner_ids.tolist()
            gains += top_scores.tolist()
            lookups.append(1)
            timelapse.append(time.time() - t0)
            rest = self.candidate_ids[b:]
            if self.keep_unselected:
                unselected = np.setdiff1d(batch, winner_ids, assume_unique=False)
                self.candidate_ids = np.concatenate([rest, unselected])
            else:
                self.candidate_ids = rest
        self.folded_ids = list(selected)
        return selected[:subset_size], gains, timelapse, lookups
