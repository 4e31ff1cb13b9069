"""Pairwise mutual information over cluster assignments (PyTorch).

Port of ``acav100m_tpu/ops/mi.py``: the eps-filled contingency cache
(reference ``measures/mi.py:32-39``), the full-table scorers (MI, AMI with
its expected MI, NMI, the constant measure and the pair-counting FM, Rand
and adjusted Rand indices, ``mi.py:85-230``), the incremental O(W*P) MI
score (``EfficientMemMI``, ``mi.py:284-412``), the batched greedy selector
(``EfficientBatchMI``, ``measures/batch.py``) and the whole-pool greedy
selector (``EfficientMI.run_greedy``, ``mi.py:150-192``).

    cache: N (P,C,C) eps-filled, a = N.sum(1) (P,C), b = N.sum(2) (P,C),
           n = a.sum(-1) (P)

NB margins: ``a`` sums over the first cluster axis, so it is indexed by the
second view, and ``b`` by the first. The incremental scorer reads cells by
gathers; they return the same values as the JAX package's one-hot einsums.
The full-table scorers build each candidate's (P,C,C) table as a one-hot
outer product and score the cache plus it, as the JAX package does. Winners
are folded into the cache by first summing their (exactly integer) one-hot
contributions and then adding the sum to the cache, the JAX package's order
of operations, so caches agree bit for bit. Top-k breaks ties by the lowest
index (a stable descending sort), like ``lax.top_k``; ``torch.topk`` orders
ties arbitrarily. ``torch.argmax`` returns the first maximal index, like
``jnp.argmax``.

Both selectors take ``group=`` (a ``runtime.Group``, one process per card;
the JAX package's ``mesh=``) to split the candidate axis over the ranks:
each rank scores a contiguous slice, the scores are all-gathered in
candidate order, and every rank takes the same winners by the single-device
tie rule and folds them into an identical cache. The full-table scorers then
build only their slice's (W/world, P, C, C) tables on each card.

On a card, the batched selector's step with the incremental score in
float32 and no group is one launch of ``csrc/batch_mi_step.cu``
(``batch_mi_step``): gather, score, top-k, fold and statistics, with the
cache and statistics updated in place. ``batch_mi_step_ref`` is its plain
twin, the eager chain that every other case runs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..runtime import Group, all_gather_cat, group_device
from . import cuda_build

Tensor = torch.Tensor
EPS = float(np.finfo("float64").eps)

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


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
    """(V, D) assignments + P pairs -> (V, P, 2) pair coordinates, C order."""
    comb = np.asarray(list(combinations), dtype=np.int64)  # (P, 2)
    return np.ascontiguousarray(np.stack(
        [assignments[:, comb[:, 0]], assignments[:, comb[:, 1]]], axis=-1
    ), dtype=np.int32)


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


def candidate_tables(pairs: Tensor, ncentroids: int,
                     dtype=torch.float32) -> Dict[str, Tensor]:
    """One-hot contingency contributions of W candidates: pairs (W,P,2) ->
    {'N': (W,P,C,C), 'a': (W,P,C), 'b': (W,P,C), 'n': (W,P)} (reference
    mi.py:47-59)."""
    p1, p2 = _onehots(pairs, ncentroids, dtype)
    n_mat = torch.einsum("wpa,wpb->wpab", p1, p2)
    a = n_mat.sum(2)
    b = n_mat.sum(3)
    return {"N": n_mat, "a": a, "b": b, "n": b.sum(-1)}


# -- full-table scores: (W,P,C,C) tables -> (W,P) ------------------------------

def _mi_terms(last: Dict) -> Tensor:
    n_mat = last["N"]
    a = last["a"][:, :, None, :]  # W P 1 C
    b = last["b"][:, :, :, None]  # W P C 1
    n = last["n"][:, :, None, None]
    return n_mat / n * (torch.log(n_mat) + torch.log(n) - (torch.log(a) + torch.log(b)))


def calc_mi(last: Dict) -> Tensor:
    """MI of each table (reference mi.py:85-91)."""
    return _mi_terms(last).sum(dim=(2, 3))


def calc_entropy(x: Tensor, n: Tensor) -> Tensor:
    p = x / n
    return -(p * torch.log(p)).sum(-1)


def generalized_mean(ha: Tensor, hb: Tensor, average_method: str = "arithmetic") -> Tensor:
    if average_method == "max":
        return torch.maximum(ha, hb)
    if average_method == "min":
        return torch.minimum(ha, hb)
    return (ha + hb) / 2.0


def calc_emi(last: Dict) -> Tensor:
    """Expected MI under the hypergeometric model (reference mi.py:217-230)."""
    n_mat = last["N"]
    a = last["a"][:, :, None, :]
    b = last["b"][:, :, :, None]
    n = last["n"][:, :, None, None]
    lg = torch.lgamma
    log_term2 = (
        lg(a + 1) + lg(b + 1) + lg(n - a + 1) + lg(n - b + 1)
        - (lg(n + 1) + lg(n_mat + 1) + lg(a - n_mat + 1) + lg(b - n_mat + 1)
           + lg(n - a - b + n_mat + 1))
    )
    return (_mi_terms(last) * torch.exp(log_term2)).sum(dim=(2, 3))


def ensure_nonzero(x: Tensor) -> Tensor:
    return torch.clamp_min(x, EPS)


def calc_ami(last: Dict, average_method: str = "arithmetic") -> Tensor:
    mi = calc_mi(last)
    emi = calc_emi(last)
    ha = calc_entropy(last["a"], last["n"][..., None])
    hb = calc_entropy(last["b"], last["n"][..., None])
    normalizer = generalized_mean(ha, hb, average_method)
    return (mi - emi) / ensure_nonzero(normalizer - emi)


def calc_nmi(last: Dict, average_method: str = "arithmetic") -> Tensor:
    mi = calc_mi(last)
    ha = calc_entropy(last["a"], last["n"][..., None])
    hb = calc_entropy(last["b"], last["n"][..., None])
    return 2.0 * mi / ensure_nonzero(generalized_mean(ha, hb, average_method))


def calc_constant(last: Dict) -> Tensor:
    return torch.ones_like(last["n"])


def _comb2(x: Tensor) -> Tensor:
    return x * (x - 1.0) / 2.0


def _pair_stats(last: Dict):
    """Pair-counting sums (reference correspondence_retrieval
    measures/efficient_pair.py:23-131): S_ab = sum comb(N,2),
    S_a = sum comb(a,2), S_b = sum comb(b,2), nc = comb(n,2)."""
    s_ab = _comb2(last["N"]).sum(dim=(2, 3))
    s_a = _comb2(last["a"]).sum(-1)
    s_b = _comb2(last["b"]).sum(-1)
    return s_ab, s_a, s_b, _comb2(last["n"])


def calc_fm(last: Dict) -> Tensor:
    """Fowlkes-Mallows: S_ab / sqrt(S_a * S_b)."""
    s_ab, s_a, s_b, _ = _pair_stats(last)
    return s_ab / torch.sqrt(ensure_nonzero(s_a * s_b))


def calc_rand(last: Dict) -> Tensor:
    """Rand index: (TP + TN) / comb(n, 2)."""
    s_ab, s_a, s_b, nc = _pair_stats(last)
    tn = nc - (s_a + s_b - s_ab)
    return (s_ab + tn) / ensure_nonzero(nc)


def calc_arand(last: Dict) -> Tensor:
    """Adjusted Rand index."""
    s_ab, s_a, s_b, nc = _pair_stats(last)
    expected = s_a * s_b / ensure_nonzero(nc)
    return (s_ab - expected) / ensure_nonzero(0.5 * (s_a + s_b) - expected)


_SCORE_FNS = {
    "mi": lambda last, avg: calc_mi(last),
    "ami": calc_ami,
    "nmi": calc_nmi,
    "constant": lambda last, avg: calc_constant(last),
    "fm": lambda last, avg: calc_fm(last),
    "rand": lambda last, avg: calc_rand(last),
    "arand": lambda last, avg: calc_arand(last),
}


def _pair_mean(scores: Tensor, pair_weights=None) -> Tensor:
    """(W, P) -> (W,): plain or weighted mean over pairs."""
    if pair_weights is None:
        return scores.mean(-1)
    w = torch.as_tensor(pair_weights, dtype=scores.dtype, device=scores.device)
    return (scores * w).sum(-1) / torch.clamp(w.sum(), min=EPS)


def score_candidates_full(cache: Dict, pairs: Tensor, ncentroids: int,
                          kind: str = "mi", average_method: str = "arithmetic",
                          pair_weights=None) -> Tensor:
    """Score each of W candidates (pairs (W,P,2)) as if added alone to the
    cache -> (W,): the full (W,P,C,C) tables (reference get_last +
    _calc_score, mi.py:93-98, batch.py:123-130), then the mean over pairs."""
    tables = candidate_tables(pairs, ncentroids, cache["N"].dtype)
    last = {key: cache[key][None] + tables[key] for key in cache}
    return _pair_mean(_SCORE_FNS[kind](last, average_method), pair_weights)


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


def score_sharded(score, pairs: Tensor, group: Optional[Group]) -> Tensor:
    """``score`` (pairs (W,P,2) -> (W,)) over the candidates; with ``group``
    (W a multiple of its world size) each rank scores its contiguous W/world
    slice and the slices are all-gathered in candidate order."""
    if group is None:
        return score(pairs)
    per = pairs.shape[0] // group.world_size
    return all_gather_cat(score(pairs[group.rank * per:(group.rank + 1) * per]), group)


def _pad_rows(n: int, group: Optional[Group]) -> int:
    """``n`` rounded up to a multiple of the group's world size."""
    world = group.world_size if group is not None else 1
    return -(-n // world) * world


def stable_top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k values and indices, ties to the lowest index (``lax.top_k``)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def batch_mi_step_ref(cache: Dict, stats: Dict, pairs_all: Tensor, ids: Tensor, valid: int,
                      k: int, ncentroids: int, pair_weights=None, score=None):
    """One greedy step as an eager chain: the plain twin of
    ``batch_mi_step``, and the step of every case the kernel does not take.
    Candidates ``ids`` (B,) of ``pairs_all`` (V,P,2), the first ``valid`` of
    them real, are scored by ``score(pairs)`` (by default
    ``score_candidates_mem`` with ``pair_weights``); the others (a tail
    batch's pads) score -inf, the k best win (ties to the lowest index) and
    the valid winners are folded into the cache. Returns (top_idx,
    top_scores, cache, stats), new tensors."""
    pairs = pairs_all[ids]
    mask = torch.arange(ids.shape[0], device=ids.device) < valid
    if score is None:
        scores = score_candidates_mem(cache, stats, pairs, ncentroids, pair_weights)
    else:
        scores = score(pairs)
    scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    top_scores, top_idx = stable_top_k(scores, k)
    cache = add_candidates_to_cache(cache, pairs[top_idx], ncentroids, weights=mask[top_idx])
    return top_idx, top_scores, cache, mem_stats(cache)


BATCH_MI_MAX_B = 512  # candidates a step the kernel takes (MAX_B in its source)


@functools.lru_cache(maxsize=None)
def _bind_batch_mi():
    fn = cuda_build.load("batch_mi_step").batch_mi_step
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    return fn


def batch_mi_step(cache: Dict, stats: Dict, pairs_all: Tensor, ids: np.ndarray, valid: int,
                  k: int, weights: Optional[Tensor] = None, out: Optional[Tensor] = None,
                  out_host: Optional[Tensor] = None) -> Tensor:
    """One greedy step in one launch of ``csrc/batch_mi_step.cu`` on the
    current stream: candidates ``ids`` (B,) int64 host ids into
    ``pairs_all`` (V,P,2) int32, the first ``valid`` of them real, scored by
    the incremental MI (the mean over pairs, weighted by ``weights`` (P,) if
    given); the k best (ties to the lowest index) are folded into ``cache``
    and ``stats`` recomputed, both in place. Returns ``out`` (2k int32 on
    the card: the k indices into ``ids``, then the bits of their float32
    scores), copied into the pinned ``out_host`` too if given. CUDA float32
    tensors only; raises ``ValueError`` on what the kernel does not take (B
    over ``BATCH_MI_MAX_B``, k over B)."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    b = ids.shape[0]
    if ids.ndim != 1 or not 1 <= b <= BATCH_MI_MAX_B or not 1 <= k <= b or not 1 <= valid <= b:
        raise ValueError(f"the kernel takes 1 <= valid <= B <= {BATCH_MI_MAX_B} ids and "
                         f"1 <= k <= B, got ids {ids.shape}, valid {valid}, k {k}")
    n_mat = cache["N"]
    device, (p, c) = n_mat.device, (n_mat.shape[0], n_mat.shape[-1])
    tensors = [("N", n_mat, (p, c, c)), ("a", cache["a"], (p, c)), ("b", cache["b"], (p, c)),
               ("n", cache["n"], (p,))]
    tensors += [(name, stats[name], (p,)) for name in ("NlogN", "aloga", "blogb")]
    if weights is not None:
        tensors.append(("weights", weights, (p,)))
    for name, t, shape in tensors:
        if (t.device != device or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: the kernel takes a contiguous float32 {shape} tensor "
                             f"on the card, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (device.type != "cuda" or pairs_all.device != device or pairs_all.dtype != torch.int32
            or pairs_all.dim() != 3 or pairs_all.shape[1:] != (p, 2)
            or not pairs_all.is_contiguous() or pairs_all.data_ptr() % 8):
        raise ValueError(f"pairs_all must be a contiguous, 8-byte aligned (V, {p}, 2) int32 "
                         f"tensor on the card beside the cache, got {pairs_all.dtype} "
                         f"{tuple(pairs_all.shape)} on {pairs_all.device}")
    if out is None:
        out = torch.empty(2 * k, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _bind_batch_mi()(
            pairs_all.data_ptr(), ids.ctypes.data, pairs_all.shape[0], b, valid, k, p, c,
            *(t.data_ptr() for _, t, _ in tensors[:7]),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            None if out_host is None else out_host.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "batch_mi_step")
    tracing.count("batch_mi.launches")
    return out


class BatchGreedySelector:
    """Greedy batched MI maximization (reference batch.py:10-260).

    Per iteration: take the next ``batch_size`` candidates from a shuffled
    pool, score each as if added alone, select the ``selection_size`` best,
    fold them into the cache; unselected candidates return to the back of
    the pool when ``keep_unselected``. Pool bookkeeping is host numpy with
    the caller's ``RandomState``; scoring runs on ``device``. The batch has
    a static size B: a short tail batch is padded and its pads scored -inf
    and folded with weight 0, as in the JAX package. ``scorer`` is ``mem``
    (the incremental MI score) or a kind of the full-table scorers
    (``_SCORE_FNS``), averaged over pairs with ``average_method``. With
    ``group`` each batch is padded to a multiple of the world size (pads
    masked as above) and its candidates are scored across the ranks.

    ``fused`` (``takes_kernel``), fixed at construction: on a card, in
    float32, with the ``mem`` scorer and no group, a step is one launch of
    ``batch_mi_step`` (the cache and statistics updated in place, the picks
    read back in one copy into pinned memory); every other case runs the
    eager chain of ``batch_mi_step_ref``.
    """

    def __init__(
        self,
        assignments: np.ndarray,  # (V, D) ints
        combinations: Sequence[Tuple[int, int]],
        ncentroids: int,
        batch_size: int = 20,
        selection_size: int = 4,
        keep_unselected: bool = True,
        scorer: str = "mem",
        average_method: str = "arithmetic",
        seed: Optional[int] = None,
        rng: Optional[np.random.RandomState] = None,
        pair_weights=None,
        dtype="float32",
        device=None,
        group: Optional[Group] = None,
    ):
        if scorer != "mem" and scorer not in _SCORE_FNS:
            raise ValueError(f"unknown scorer {scorer!r}")
        self.assignments = np.asarray(assignments)
        self.combinations = list(combinations)
        self.C = int(ncentroids)
        self.B = int(batch_size)
        self.k = int(selection_size)
        self.keep_unselected = keep_unselected
        self.scorer = scorer
        self.average_method = average_method
        self.pair_weights = (
            np.asarray(pair_weights, np.float32) if pair_weights is not None else None
        )
        self.rng = rng if rng is not None else np.random.RandomState(seed)
        self.dtype = resolve_dtype(dtype)
        self.group = group
        self.device = group_device(device, group)
        pairs_np = pair_assignments(self.assignments, self.combinations)
        self.pairs_all = torch.as_tensor(pairs_np, device=self.device)  # (V,P,2)
        self.cache = init_cache(len(self.combinations), self.C, self.dtype,
                                self.device)
        self.stats = mem_stats(self.cache)
        self.candidate_ids = np.arange(self.assignments.shape[0], dtype=np.int64)
        self.fused = self.takes_kernel(self.device, self.dtype, scorer, group)
        if self.fused:
            b_dev = _pad_rows(self.B, group)
            if b_dev > BATCH_MI_MAX_B:
                raise ValueError(f"batch_size {b_dev} is over the fused step's "
                                 f"{BATCH_MI_MAX_B}")
            self._weights = (None if self.pair_weights is None else
                             torch.as_tensor(self.pair_weights, device=self.device))
            self._out = torch.empty(2 * b_dev, dtype=torch.int32, device=self.device)
            self._out_host = torch.empty(2 * b_dev, dtype=torch.int32, pin_memory=True)

    @staticmethod
    def takes_kernel(device, dtype, scorer: str, group: Optional[Group]) -> bool:
        """Whether a step is the kernel's (``batch_mi_step``): CUDA, float32,
        the ``mem`` scorer, no group."""
        return (torch.device(device).type == "cuda" and dtype == torch.float32
                and scorer == "mem" and group is None)

    def _score(self, pairs: Tensor) -> Tensor:
        if self.scorer == "mem":
            return score_candidates_mem(self.cache, self.stats, pairs, self.C,
                                        pair_weights=self.pair_weights)
        return score_candidates_full(self.cache, pairs, self.C, self.scorer,
                                     self.average_method, self.pair_weights)

    def _step(self, batch_dev: np.ndarray, valid: int):
        """Score the batch's candidates (host ids, the first ``valid`` real),
        take the k best and fold them into the cache; returns what
        ``_read_picks`` reads the picks from."""
        k = min(self.k, len(batch_dev))
        if self.fused:
            batch_mi_step(self.cache, self.stats, self.pairs_all, batch_dev, valid, k,
                          self._weights, self._out, self._out_host)
            return k
        top_idx, top_scores, self.cache, self.stats = batch_mi_step_ref(
            self.cache, self.stats, self.pairs_all,
            torch.as_tensor(batch_dev, device=self.device), valid, k, self.C,
            score=lambda pairs: score_sharded(self._score, pairs, self.group))
        return top_idx, top_scores

    def _read_picks(self, picks):
        """The step's winners (indices into the batch) and their scores on
        the host: the kernel's one copy, or the eager chain's two reads."""
        if self.fused:
            torch.cuda.current_stream(self.device).synchronize()
            tracing.count("select.host_reads")
            out = self._out_host.numpy()
            return (out[:picks].astype(np.int64),
                    out[picks:2 * picks].view(np.float32).astype(np.float64))
        top_idx, top_scores = picks
        top_idx = top_idx.cpu().numpy()
        tracing.count("select.host_reads")
        top_scores = top_scores.double().cpu().numpy()  # numpy has no bf16
        tracing.count("select.host_reads")
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
        with tracing.span("span.select.start"):
            self.modify_k(subset_size)
            self.add_samples(list(start_indices))
            b_dev = _pad_rows(self.B, self.group)
        iteration = 0
        while len(selected) < subset_size:
            with tracing.span("span.select.iteration", unit=iteration):
                with tracing.span("span.select.shuffle"):
                    t0 = time.time()
                    self.shuffle_candidates()
                    b = min(self.B, len(self.candidate_ids))
                    if b == 0:
                        break
                    batch = self.candidate_ids[:b]
                    if b < b_dev:  # pad to the static size; pads are masked
                        batch_dev = np.concatenate([batch, np.full(b_dev - b, batch[0])])
                    else:
                        batch_dev = batch
                with tracing.span("span.select.dispatch"):
                    picks = self._step(batch_dev, b)
                with tracing.span("span.select.read_picks"):
                    top_idx, top_scores = self._read_picks(picks)
                with tracing.span("span.select.bookkeeping"):
                    if b < b_dev:
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
                tracing.count("select.iterations")
                tracing.count("select.picks", len(winner_ids))
            iteration += 1
        self.folded_ids = list(selected)
        return selected[:subset_size], gains, timelapse, lookups


class GreedySelector:
    """One winner per iteration, scored over the WHOLE candidate pool
    (reference ``EfficientMI.run_greedy``, mi.py:150-192): every step scores
    every candidate against the cache, masks the taken ones to -inf, takes
    the first maximal index and folds it into the cache.

    ``kind`` is a full-table measure (``_SCORE_FNS``); ``scorer`` ``mem``
    (the default for ``mi``, and valid only for it) scores MI
    incrementally. The pool lives on ``device``; the taken-mask is host
    numpy, as in the JAX package. With ``group`` the pool is padded to a
    multiple of the world size with repeats of row 0, which stay inactive,
    and each rank scores its slice of it.
    """

    def __init__(
        self,
        assignments: np.ndarray,
        combinations: Sequence[Tuple[int, int]],
        ncentroids: int,
        kind: str = "mi",
        average_method: str = "arithmetic",
        scorer: Optional[str] = None,
        pair_weights=None,
        dtype="float32",
        device=None,
        group: Optional[Group] = None,
    ):
        if kind not in _SCORE_FNS:
            raise ValueError(f"unknown measure kind {kind!r}")
        self.scorer = scorer or ("mem" if kind == "mi" else "full")
        if self.scorer == "mem" and kind != "mi":
            raise ValueError(f"scorer 'mem' computes MI only, not {kind!r}")
        self.assignments = np.asarray(assignments)
        self.combinations = list(combinations)
        self.C = int(ncentroids)
        self.kind = kind
        self.average_method = average_method
        self.pair_weights = (
            np.asarray(pair_weights, np.float32) if pair_weights is not None else None
        )
        self.dtype = resolve_dtype(dtype)
        self.group = group
        self.device = group_device(device, group)
        pairs_np = pair_assignments(self.assignments, self.combinations)
        v = pairs_np.shape[0]
        pad = _pad_rows(v, group) - v
        if pad:  # repeats of row 0, never active (the JAX package's mesh padding)
            pairs_np = np.concatenate([pairs_np, np.repeat(pairs_np[:1], pad, 0)])
        self.pairs_all = torch.as_tensor(pairs_np, device=self.device)  # (V,P,2)
        self.cache = init_cache(len(self.combinations), self.C, self.dtype,
                                self.device)
        self.stats = mem_stats(self.cache)
        self.active = np.arange(pairs_np.shape[0]) < v

    def _score(self, pairs: Tensor) -> Tensor:
        if self.scorer == "mem":
            return score_candidates_mem(self.cache, self.stats, pairs,
                                        self.C, pair_weights=self.pair_weights)
        return score_candidates_full(self.cache, pairs, self.C, self.kind,
                                     self.average_method, self.pair_weights)

    def _scores(self) -> Tensor:
        return score_sharded(self._score, self.pairs_all, self.group)

    def _step(self) -> Tuple[int, float]:
        scores = self._scores()
        active = torch.as_tensor(self.active, device=self.device)
        scores = torch.where(active, scores, torch.tensor(
            -math.inf, dtype=scores.dtype, device=scores.device))
        idx = torch.argmax(scores)
        self.cache = add_candidates_to_cache(self.cache, self.pairs_all[idx[None]],
                                             self.C)
        self.stats = mem_stats(self.cache)
        return int(idx), float(scores[idx])

    def scores(self) -> np.ndarray:
        """Score every candidate against the current cache (diagnostics)."""
        return self._scores().double().cpu().numpy()  # numpy has no bf16

    def add_samples(self, ids: Sequence[int]):
        ids = np.asarray(list(ids), dtype=np.int64)
        if ids.size == 0:
            return
        pairs = self.pairs_all[torch.as_tensor(ids, device=self.device)]
        self.cache = add_candidates_to_cache(self.cache, pairs, self.C)
        self.stats = mem_stats(self.cache)
        self.active[ids] = False

    def run_greedy(self, subset_size: int, start_indices: Sequence[int] = (),
                   fold_start: bool = True):
        """Returns (S, GAIN, timelapse, LOOKUPS). ``fold_start`` selects
        between the reference's two start-index semantics: the retrieval
        suite folds start samples into the cache (correspondence_retrieval
        measures/efficient.py:249), while stage 6's pool greedy only gives
        them output slots, so its cache starts empty (subset_selection
        measures/mi.py:150-173). S holds the start indices, and the loop
        runs to ``subset_size - 1`` as the reference's does (mi.py:161)."""
        import time

        selected = list(start_indices)
        if fold_start:
            self.add_samples(start_indices)
        else:
            ids = np.asarray(list(start_indices), dtype=np.int64)
            if ids.size:
                self.active[ids] = False
        gains: List[float] = []
        timelapse: List[float] = []
        lookups: List[int] = []
        while len(selected) < subset_size - 1:
            t0 = time.time()
            idx, score = self._step()
            self.active[idx] = False
            selected.append(idx)
            gains.append(score)
            timelapse.append(time.time() - t0)
            lookups.append(0)
        return selected, gains, timelapse, lookups
