"""Alternative subset-selection measure: contrastive alignment ranking.

Port of ``acav100m_tpu/pipeline/contrastive_selection.py`` (reference
``subset_selection/code/measures/contrastive/``, ``run_contrastive.py`` and
``do_sample.py``): train a small two-projection contrastive probe on the
extracted penultimate features (video layer_4 2304-d, audio layer_4 128-d
-> 128-d projections, L2-normalised, InfoNCE temperature 0.1, AdamW with a
linear warmup-decay), then rank every clip by the inner product of its two
projections and keep the top fraction.

The training trajectory is the reference's (and the JAX package's):

* ``torch.optim.AdamW`` with ``amsgrad=True``, ``eps=1e-6``, betas
  (0.9, 0.999) and ``weight_decay=0.01``, in its single-tensor
  implementation (``foreach=False``; ``measures/contrastive/contrastive.py:27-35``);
* the lr is set ONCE PER EPOCH, ``lr_func_linear(epoch+1, num_epochs+1,
  warmup)`` (``:43-52``);
* gradients are NEVER zeroed: the reference's ``train_batch`` runs
  ``loss.backward(); optimizer.step()`` with no ``zero_grad`` (``:91-99``),
  so each step's ``.grad`` is the running sum of every gradient so far.
  ``train_probe`` keeps this by default (``accumulate_grads=True``).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..utils.io import load_pickle, save_output_csv

TEMPERATURE = 0.1
PROJECTION_SIZE = 128


def load_penultimate_features(shard_paths: Sequence) -> Tuple[np.ndarray, np.ndarray, List[Dict]]:
    """Feature pkls -> (video (V, 2304), audio (V, 128), row metas), from
    the last layer of each layer extractor (feature_loaders/loader.py)."""
    vids, auds, metas = [], [], []
    for path in shard_paths:
        try:
            rows = load_pickle(path)
        except Exception as e:
            print(f"skipping unreadable shard {path}: {e}")
            continue
        for row in rows:
            v = row["video_features"][0]["array"]
            a = row["audio_features"][0]["array"]
            if isinstance(v, dict):
                v = v[sorted(v)[-1]]
            if isinstance(a, dict):
                a = a[sorted(a)[-1]]
            vids.append(np.asarray(v, np.float32))
            auds.append(np.asarray(a, np.float32))
            metas.append({"filename": row["filename"], "shard_name": row["shard_name"]})
    if not vids:
        return np.zeros((0, 1)), np.zeros((0, 1)), []
    return np.stack(vids), np.stack(auds), metas


class ContrastiveProbe(nn.Module):
    """Two linear projections to ``PROJECTION_SIZE``, L2-normalised (the
    reference's ``ContrastiveModule``, with its layer names)."""

    def __init__(self, video_dim: int, audio_dim: int):
        super().__init__()
        self.visual_linear = nn.Linear(video_dim, PROJECTION_SIZE)
        self.audio_linear = nn.Linear(audio_dim, PROJECTION_SIZE)

    def forward(self, video: torch.Tensor, audio: torch.Tensor):
        zv = F.normalize(self.visual_linear(video), dim=-1, eps=1e-12)
        za = F.normalize(self.audio_linear(audio), dim=-1, eps=1e-12)
        return zv, za


def init_probe(video_dim: int, audio_dim: int, seed: int = 0) -> ContrastiveProbe:
    """``nn.Linear``'s default init (weight and bias uniform in
    +-1/sqrt(fan_in)) drawn from a ``torch.Generator`` seeded with ``seed``
    on the CPU, so the initial probe is the same on every device."""
    gen = torch.Generator().manual_seed(seed)
    probe = ContrastiveProbe(video_dim, audio_dim)
    with torch.no_grad():
        for lin in (probe.visual_linear, probe.audio_linear):
            bound = 1.0 / np.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)
    return probe


def probe_from_jax(params: Dict) -> ContrastiveProbe:
    """The JAX package's probe parameters ``{"wv", "bv", "wa", "ba"}``
    (weights (in, out)) -> a float32 ``ContrastiveProbe`` (``nn.Linear``
    weights are (out, in))."""
    p = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}
    probe = ContrastiveProbe(p["wv"].shape[0], p["wa"].shape[0])
    with torch.no_grad():
        probe.visual_linear.weight.copy_(p["wv"].T)
        probe.visual_linear.bias.copy_(p["bv"])
        probe.audio_linear.weight.copy_(p["wa"].T)
        probe.audio_linear.bias.copy_(p["ba"])
    return probe


def _logits(probe, video, audio, temperature):
    zv, za = probe(video, audio)
    return zv @ za.T / temperature


def probe_loss(probe, video, audio, temperature: float = TEMPERATURE) -> torch.Tensor:
    """The reference loss ``(sum_xent(ab) + sum_xent(ba)) / (2B)``
    (module.py:54-74): the mean of the two directions' mean cross-entropy."""
    logits = _logits(probe, video, audio, temperature)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def probe_accuracy(probe, video, audio, temperature: float = TEMPERATURE) -> torch.Tensor:
    """The mean of both directions' top-1 rates x100 (module.py:76-86)."""
    logits = _logits(probe, video, audio, temperature)
    labels = torch.arange(logits.shape[0], device=logits.device)
    top1_v = (logits.argmax(-1) == labels).sum()
    top1_a = (logits.T.argmax(-1) == labels).sum()
    return (top1_v + top1_a) / (2 * logits.shape[0]) * 100.0


def lr_func_linear(current_step: int, num_training_steps: int,
                   num_warmup_steps: int = 3) -> float:
    """Linear warmup-decay ramp over EPOCHS (contrastive.py:43-47)."""
    if current_step < num_warmup_steps:
        return float(current_step) / float(max(1, num_warmup_steps))
    return max(0.0, float(num_training_steps - current_step)
               / float(max(1, num_training_steps - num_warmup_steps)))


def train_probe(
    video: np.ndarray,
    audio: np.ndarray,
    num_epochs: int = 3,
    batch_size: int = 128,
    base_lr: float = 2e-4,
    warmup_steps: int = 1,
    seed: int = 0,
    params: Optional[Dict] = None,
    accumulate_grads: bool = True,
    device=None,
) -> ContrastiveProbe:
    """Train the probe on the reference's trajectory; returns it on
    ``device`` (default ``cuda``).

    Defaults mirror the subset_selection config ``contrastive``
    (config.py:37-44). ``params`` injects the initial parameters in the JAX
    package's form (``probe_from_jax``); without it the probe starts from
    ``init_probe(seed)``. Each epoch visits the clips in the order of
    ``np.random.RandomState(seed).permutation``, tail batches included
    (the reference DataLoader's drop_last=False)."""
    device = resolve_device(device)
    v = video.shape[0]
    batch_size = min(batch_size, v)
    probe = (probe_from_jax(params) if params is not None
             else init_probe(video.shape[1], audio.shape[1], seed))
    probe = probe.to(device).train()
    opt = torch.optim.AdamW(probe.parameters(), lr=base_lr, betas=(0.9, 0.999), eps=1e-6,
                            weight_decay=0.01, amsgrad=True, foreach=False, fused=False)
    video_d = torch.as_tensor(video, dtype=torch.float32, device=device)
    audio_d = torch.as_tensor(audio, dtype=torch.float32, device=device)
    rng = np.random.RandomState(seed)
    for epoch in range(num_epochs):
        for group in opt.param_groups:
            group["lr"] = lr_func_linear(epoch + 1, num_epochs + 1, warmup_steps) * base_lr
        order = rng.permutation(v)
        for i in range(0, v, batch_size):
            idx = torch.as_tensor(order[i : i + batch_size], device=device)
            if not accumulate_grads:
                opt.zero_grad()
            probe_loss(probe, video_d[idx], audio_d[idx]).backward()
            opt.step()
    return probe.eval()


@torch.no_grad()
def alignment_scores(probe: ContrastiveProbe, video: np.ndarray, audio: np.ndarray) -> np.ndarray:
    """Per-clip inner products of the aligned projections (the ranking
    score), on the probe's device."""
    device = next(probe.parameters()).device
    zv, za = probe(torch.as_tensor(video, dtype=torch.float32, device=device),
                   torch.as_tensor(audio, dtype=torch.float32, device=device))
    return (zv * za).sum(-1).cpu().numpy()


def rank_and_cut(metas: Sequence[Dict], scores: np.ndarray,
                 subset_ratio: float = 0.2,
                 subset_size: Optional[int] = None,
                 dedupe: bool = True) -> List[Dict]:
    """Sort by score desc, dedupe by filename, cut top-k
    (``do_sample.py:25-177``). Ties break by filename ascending like the
    reference's ``sort -k 1,1gr -k 2``."""
    order = sorted(range(len(metas)),
                   key=lambda i: (-scores[i], metas[i]["filename"]))
    if subset_size is None:
        subset_size = round(subset_ratio * len(metas))
    out, seen = [], set()
    for i in order:
        meta = metas[i]
        key = meta["filename"]
        if dedupe and key in seen:
            continue
        seen.add(key)
        out.append({**meta, "score": float(scores[i])})
        if len(out) >= subset_size:
            break
    return out


def run_contrastive_selection(
    shard_paths: Sequence,
    out_path,
    metas_by_shard: Optional[Dict] = None,
    subset_ratio: float = 0.2,
    subset_size: Optional[int] = None,
    num_epochs: int = 3,
    batch_size: int = 128,
    base_lr: float = 2e-4,
    seed: int = 0,
    device="cuda",
) -> Tuple[Optional[Path], int]:
    """Features -> trained probe -> ranked, cut ``output.csv`` rows
    ``shard_name,filename,id,segment``; the probe trains on ``device``."""
    device = resolve_device(device)
    video, audio, metas = load_penultimate_features(shard_paths)
    if len(metas) == 0:
        return None, 0
    probe = train_probe(video, audio, num_epochs, batch_size, base_lr, seed=seed,
                        device=device)
    scores = alignment_scores(probe, video, audio)
    selected = rank_and_cut(metas, scores, subset_ratio, subset_size)
    rows = [{"filename": m["filename"], "shard_name": m["shard_name"]} for m in selected]
    return save_output_csv(rows, metas_by_shard or {}, Path(out_path))


def merge_contrastive_csvs(cache_csvs, out_path, subset_size=None,
                           subset_ratio=0.2, dedupe=True):
    """Merge per-chunk contrastive score csvs (rows
    ``shard_name,filename,score``), sort by score desc and filename asc
    (the reference's ``sort -k 1,1gr -k 2``, merge_contrastive.py:48),
    dedupe, cut top-k, and write the same format (merge_contrastive.py:16-130
    and do_sample.py)."""
    rows = []
    for path in cache_csvs:
        with open(path) as f:
            for row in csv.reader(f):
                if len(row) >= 3:
                    rows.append((row[0], row[1], float(row[2])))
    rows.sort(key=lambda r: (-r[2], r[1]))
    if subset_size is None:
        subset_size = round(subset_ratio * len(rows))
    out, seen = [], set()
    for shard, fname, score in rows:
        if dedupe and fname in seen:
            continue
        seen.add(fname)
        out.append((shard, fname, score))
        if len(out) >= subset_size:
            break
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        w = csv.writer(f)
        for row in out:
            w.writerow(row)
    return out_path, len(out)
