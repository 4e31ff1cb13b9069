"""Plain mini-batch SGD k-means: the benchmark's reference for stage 5.

ACAV100M's ``clustering/code/sgd_clustering.py`` and
``run_clustering.py``, written out in float64: rows stream shard by shard
through webdataset's buffered shuffle (``clustering/code/data/shuffle.py``,
the algorithm as vendored there), batches of ``B`` full rows (the last
partial batch dropped); while fewer than ``initial_rounds * k`` samples
have been seen, each row goes to the argmin of a uniform draw; after that
to its nearest center, distances to centers used fewer than
``(count / k) ** 0.7`` times divided by 5; then
``centers <- centers * (1 - counts * lr) + lr * sums`` with
``lr = 0.5 / max_count`` where ``lr * max_count >= 1``, and
``lr = 0.1 ** (2 + epoch // 5)``. Assignment after training takes the
nearest center with the same discount and no random branch. It imports
nothing of the program.
"""

from __future__ import annotations

import random
from typing import Iterable, Iterator, List, Optional, Tuple

import torch

INITIAL_ROUNDS, P, R = 10, 0.7, 5.0


def buffered_shuffle(source: Iterable, bufsize: int, rng: random.Random,
                     initial: int = 100) -> Iterator:
    data = iter(source)
    initial = min(initial, bufsize)
    buf: List = []
    startup = True
    for sample in data:
        if len(buf) < bufsize:
            try:
                buf.append(next(data))
            except StopIteration:
                pass
        if not buf:
            yield sample
            continue
        k = rng.randint(0, len(buf) - 1)
        sample, buf[k] = buf[k], sample
        if startup and len(buf) < initial:
            buf.append(sample)
            continue
        startup = False
        yield sample
    yield from buf


def lr(epoch: int) -> float:
    return 0.1 ** (2 + epoch // 5)


def threshold(count: int, k: int) -> float:
    """``(count / k) ** 0.7`` as a float32 computation gives it."""
    c = torch.tensor(float(count), dtype=torch.float32) / k
    return float(torch.clamp(c, min=0.0) ** P)


def distances(centers: torch.Tensor, counts: torch.Tensor, count: int,
              x: torch.Tensor) -> torch.Tensor:
    """(M,K,D), (M,K), (M,B,D) -> (M,K,B) discounted squared distances."""
    d = ((x * x).sum(-1)[:, None, :] - 2.0 * centers @ x.transpose(1, 2)
         + (centers * centers).sum(-1)[:, :, None])
    under = counts < threshold(count, centers.shape[1])
    return torch.where(under[:, :, None], d / R, d)


def step(centers: torch.Tensor, counts: torch.Tensor, count: int, x: torch.Tensor,
         lr_: float, rand: Optional[torch.Tensor], mask: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update from (centers, counts, count) on x: (new centers, counts
    added this step)."""
    k = centers.shape[1]
    if count < INITIAL_ROUNDS * k:
        best = torch.argmin(rand.to(x.device), dim=1)
    else:
        best = torch.argmin(distances(centers, counts, count, x), dim=1)
    onehot = torch.nn.functional.one_hot(best, k).to(x.dtype)  # (M,B,K)
    added = onehot.sum(1)
    sums = onehot.transpose(1, 2) @ x
    max_count = added.max(-1, keepdim=True).values
    eff = torch.where(max_count * lr_ >= 1.0, 0.5 / max_count.clamp(min=1.0),
                      torch.full_like(max_count, lr_))
    new = (centers * (1.0 - added * eff)[:, :, None] + sums * eff[:, :, None]) * mask[:, None, :]
    return new, added
