"""Evaluation-suite training: contrastive pretrain + linear eval.

The counterpart of ``acav100m_tpu/evaluation/train.py``, rebuilt from the
reference's ``evaluation/code/{contrast_net,classify_net}.py``,
``utils/lr_policy.py``, ``models/optimizer.py`` and ``utils/checkpoint.py``:

* lr policies: cosine / linear with linear warmup (lr_policy.py:6-61),
  the JAX package's quirks included;
* optimizers: ``torch.optim`` AdamW (amsgrad), Adam and nesterov SGD, which
  the JAX package's ``scale_by_torch_adam`` / ``scale_by_torch_sgd`` chains
  reproduce, with the reference's BN / rest weight-decay groups;
* pretrain loop: batch InfoNCE with autograd through both backbones,
  preemptible ``epoch_latest`` / ``step_latest`` checkpoints
  (contrast_net.py:105-135, 252-270) in the JAX package's flax layout;
  over a ``runtime.Group`` (the JAX package's ``mesh=``) every rank takes
  the same global batch, keeps its rows and runs the global InfoNCE and
  batch norm over the group, and the step sums the gradients over the
  ranks before the optimizer's step (the reference's DDP and SyncBN);
* linear eval: frozen backbone (eval mode under ``torch.inference_mode``),
  trainable ``ClassifyHead``, optimizer over the head only
  (classify_net.py:87), per-video score sums over the test views
  (utils/meters.py:522-689).

Every entry point runs on ``device`` (default ``cuda``, which raises
without a card).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..runtime.mesh import (
    Group,
    all_reduce_sum_flat,
    barrier,
    broadcast_flat,
    group_device,
    shard_rows,
)
from ..utils.io import dump_pickle, load_pickle
from .models import (
    AudioResNet2D,
    BatchNorm,
    ClassifyHead,
    Contrast,
    VisualResNet3D,
    backbone_state_dict_from_flax,
    contrast_loss,
    flax_from_state_dict,
    head_flax_from_state_dict,
    init_eval_weights,
    set_group,
    state_dict_from_flax,
    strip_heads,
)

DATA_MEAN = (0.45, 0.45, 0.45)
DATA_STD = (0.225, 0.225, 0.225)


# -- lr policies / optimizers --------------------------------------------------

def lr_schedule(policy: str, base_lr: float, total_steps: int,
                warmup_steps: int = 0, warmup_start_lr: float = 0.0,
                end_lr: float = 0.0) -> Callable[[int], float]:
    """Step -> lr (a Python float), mirroring utils/lr_policy.py with the
    JAX package's quirks: the LINEAR policy's warmup ramps from 0 whatever
    ``warmup_start_lr`` is (only cosine honors it), and CONSTANT ignores
    warmup."""
    if policy not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown lr policy {policy!r}")
    decay_span = max(total_steps - warmup_steps, 1)

    def schedule(count) -> float:
        step = float(count)
        if policy == "constant":
            return float(base_lr)
        warm_frac = step / max(1, warmup_steps) if warmup_steps > 0 else step * 0.0
        if policy == "linear":
            decay = max(0.0, (total_steps - step) / decay_span)
            alpha = warm_frac if step < warmup_steps else decay
            return end_lr + (base_lr - end_lr) * alpha
        warm = warmup_start_lr + (base_lr - warmup_start_lr) * warm_frac
        cosf = (math.cos(math.pi * (step - warmup_steps) / decay_span) + 1.0) * 0.5
        cos_lr = (base_lr - end_lr) * cosf + end_lr
        return warm if step < warmup_steps else cos_lr

    return schedule


def build_optimizer(name: str, named_parameters, schedule: Callable[[int], float],
                    weight_decay: float = 1e-5, bn_weight_decay: float = 0.0,
                    momentum: float = 0.9, dampening: float = 0.0, nesterov: bool = True,
                    eps: float = 1e-6, amsgrad: bool = True) -> torch.optim.Optimizer:
    """The reference's optimizer (models/optimizer.py:10-72) over
    ``named_parameters``: two groups split by ``'bn' in name``, weight decay
    ``weight_decay`` and ``bn_weight_decay``; adamw decays decoupled
    (amsgrad by default), adam and sgd coupled; eps 1e-6, betas (0.9,
    0.999); sgd nesterov with dampening 0. Step n must run at lr
    ``schedule(n)``: ``set_lr`` sets it (optax reads the step count before
    it increments, so under ``linear`` with warmup the first step runs at lr
    0)."""
    named = list(named_parameters)
    groups = [
        {"params": [p for n, p in named if "bn" not in n], "weight_decay": weight_decay},
        {"params": [p for n, p in named if "bn" in n], "weight_decay": bn_weight_decay},
    ]
    groups = [g for g in groups if g["params"]]
    lr = schedule(0)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=eps,
                                 amsgrad=amsgrad)
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=eps, amsgrad=False)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum, dampening=dampening,
                               nesterov=nesterov)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


# -- train state ------------------------------------------------------------------

@dataclass
class TrainState:
    """The model, its optimizer and lr schedule, and the steps taken."""

    model: Contrast
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def normalize_visual(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) frames -> normalized (B, 3, T, H, W) in
    ``dtype``."""
    mean = torch.tensor(DATA_MEAN, dtype=dtype, device=frames.device)
    std = torch.tensor(DATA_STD, dtype=dtype, device=frames.device)
    x = (frames.to(dtype) / 255.0 - mean) / std
    return x.permute(0, 4, 1, 2, 3).contiguous()


def model_inputs(visual, audio, device, dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch's uint8 frames (B, T, H, W, 3) and log-mels (B, 80, 128, 1),
    numpy or tensors -> the models' inputs in ``dtype`` (the parameters',
    whatever dtype the model computes in: its first convs cast them) on
    ``device``: frames normalized there (NCDHW), log-mels as (B, 1, 80,
    128)."""
    frames = visual if torch.is_tensor(visual) else torch.from_numpy(np.asarray(visual))
    lm = audio if torch.is_tensor(audio) else torch.from_numpy(np.asarray(audio))
    v = normalize_visual(frames.to(device), dtype)
    # (B, 80, 128, 1) -> (B, 1, 80, 128) with the strides of a fresh tensor:
    # a permuted size-1 channel dim counts as contiguous with stride 1, which
    # oneDNN's CPU convolution backward mishandles (heap corruption)
    return v, lm.to(device, dtype).squeeze(-1).unsqueeze(1)


def init_pretrain(seed: int = 0, schedule: Optional[Callable[[int], float]] = None,
                  device=None, dtype=None, group: Optional[Group] = None) -> TrainState:
    """A seeded ``Contrast`` (flax's default init from a CPU
    ``torch.Generator``, the same weights on every device) in train mode on
    ``device``, computing in ``dtype`` (None: float32; the parameters stay
    float32), with adamw on ``schedule`` (default: linear, lr 1e-3 over
    10000 steps, 2000 of warmup, as the JAX package's).

    With ``group`` the model runs on the group's device, its batch norms
    over the group's ranks (``set_group``), and rank 0's weights are
    broadcast to every rank, the replicated placement of the JAX
    package's mesh step."""
    device = group_device(device, group)
    model = Contrast(dtype=dtype)
    init_eval_weights(model, torch.Generator().manual_seed(seed))
    model.to(device).train()
    set_group(model, group)
    broadcast_flat([*model.parameters(), *model.buffers()], group)
    schedule = schedule or lr_schedule("linear", 1e-3, 10000, warmup_steps=2000)
    return TrainState(model, build_optimizer("adamw", model.named_parameters(), schedule),
                      schedule)


def make_pretrain_step(state: TrainState, group: Optional[Group] = None):
    """The contrastive train step: (state, visual uint8 (B,T,H,W,3), audio
    (B,80,128,1)) -> (state, {"loss", "acc"}) after one train-mode forward,
    backward and optimizer step at lr ``schedule(state.step)``; the frames
    are normalized on the model's device.

    With ``group`` (the state's, from ``init_pretrain(group=)``) the step
    takes the global batch, as the JAX package's mesh step does, and keeps
    this rank's rows (``shard_rows``: B must split evenly over the ranks);
    the loss and accuracy are the global batch's, and the gradients are
    summed over the ranks in one flat all-reduce before the optimizer's
    step, so every rank ends with the same parameters, statistics and
    optimizer state."""
    param = next(state.model.parameters())
    groups = {m.group for m in state.model.modules() if isinstance(m, BatchNorm)}
    if groups != {group}:
        raise ValueError(f"the step runs over {group} but the model's batch norms over "
                         f"{groups}: build the state with init_pretrain(group=)")
    params = list(state.model.parameters())

    def step(state: TrainState, visual, audio):
        model, optimizer = state.model, state.optimizer
        model.train()
        v, a = model_inputs(shard_rows(visual, group), shard_rows(audio, group),
                            param.device, param.dtype)
        zv, za = model(v, a)
        loss, acc = contrast_loss(zv, za, group=group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_sum_flat([p.grad for p in params if p.grad is not None], group)
        set_lr(optimizer, state.schedule(state.step))
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "acc": acc}

    return step


# -- checkpointing -----------------------------------------------------------------

def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return tree


def save_checkpoint(out_dir, state: TrainState, epoch: int,
                    name: str = "epoch_latest", backend: str = "pickle") -> Path:
    """Preemptible latest-checkpoint save (contrast_net.py:252-270), a
    pickle of numpy arrays: ``params`` / ``batch_stats`` in the JAX
    package's flax layout (so ``checkpoint.pretrained`` reads across the
    two packages), ``opt_state`` the torch optimizer's state (resumable in
    this package only), ``step`` and ``epoch``. ``backend="orbax"`` is the
    JAX package's and raises here."""
    if backend != "pickle":
        raise ValueError(f"checkpoint backend {backend!r}: orbax is the JAX package's; "
                         "the port writes pickle checkpoints")
    tree = flax_from_state_dict(state.model.state_dict())
    payload = {
        "params": tree["params"],
        "batch_stats": tree["batch_stats"],
        "opt_state": _to_numpy(state.optimizer.state_dict()),
        "step": int(state.step),
        "epoch": epoch,
    }
    return dump_pickle(payload, Path(out_dir) / f"{name}.ckpt")


def load_checkpoint(path, state: TrainState) -> Tuple[TrainState, int]:
    """Restore a ``save_checkpoint`` file into ``state`` (model, optimizer,
    step) -> (state, epoch)."""
    path = Path(path)
    if path.suffix == ".orbax" or path.is_dir():
        raise ValueError(f"{path}: orbax checkpoints are the JAX package's")
    dt = load_pickle(path)
    state.model.load_state_dict(state_dict_from_flax(
        {"params": dt["params"], "batch_stats": dt["batch_stats"]}))
    state.optimizer.load_state_dict(_to_torch(dt["opt_state"]))
    state.step = int(dt["step"])
    return state, int(dt["epoch"])


def load_pretrained_backbone(path) -> Dict:
    """Checkpoint surgery for linear eval: strip projection heads. Reads
    this package's checkpoints and the JAX package's pickle ones."""
    dt = load_pickle(path)
    return strip_heads({"params": dt["params"], "batch_stats": dt["batch_stats"]})


# -- pretrain loop ------------------------------------------------------------------

def pretrain(
    batches: Iterable[Dict[str, np.ndarray]],
    num_steps: int,
    out_dir=None,
    save_period: int = 100,
    base_lr: float = 1e-3,
    warmup_steps: int = 2000,
    seed: int = 0,
    resume: bool = True,
    log_every: int = 10,
    tb_dir=None,
    device=None,
    group: Optional[Group] = None,
) -> Tuple[TrainState, list]:
    """The contrast() pretrain loop (contrast_net.py:25-284), step-based,
    with the JAX package's meters: windowed median/average loss, iter
    timing and lr as json lines appended to ``out_dir/stats.jsonl`` and
    scalars to ``tb_dir`` when given. Unlike the JAX package's it takes no
    ``num_frames``/``crop``: a torch module needs no input to initialize.

    With ``group`` (the JAX package's ``mesh``) every rank iterates the
    same global ``batches`` and steps on its rows (``make_pretrain_step``);
    every rank resumes from ``step_latest.ckpt``, only rank 0 writes the
    checkpoints, ``stats.jsonl`` and ``tb_dir``, and the ranks meet at a
    barrier after each save."""
    from ..utils.profiling import IterTimer, Meters, TensorBoardWriter, log_json_stats

    schedule = lr_schedule("linear", base_lr, num_steps, warmup_steps=warmup_steps)
    state = init_pretrain(seed, schedule, device, group=group)
    start_epoch = 0
    if resume and out_dir is not None:
        latest = Path(out_dir) / "step_latest.ckpt"
        if latest.is_file():
            state, start_epoch = load_checkpoint(latest, state)
    step_fn = make_pretrain_step(state, group)
    lead = group is None or group.rank == 0

    def save(name: str) -> None:
        if lead:
            save_checkpoint(out_dir, state, epoch=start_epoch, name=name)
        barrier(group)

    history = []
    meters = Meters(window_size=log_every)
    timer = IterTimer(window_size=max(log_every, 2))
    writer = TensorBoardWriter(tb_dir, enabled=tb_dir is not None and lead)
    stats_path = Path(out_dir) / "stats.jsonl" if out_dir is not None and lead else None
    t0 = time.time()
    for i, batch in enumerate(batches):
        if state.step >= num_steps:
            break
        state, metrics = step_fn(state, batch["visual"], batch["audio"])
        loss = float(metrics["loss"])
        meters.add(loss=loss, acc=float(metrics["acc"]))
        timer.tick()
        if (i + 1) % log_every == 0 and not np.isfinite(loss):
            # NaN check (reference utils/misc.py:9)
            raise FloatingPointError(f"loss became non-finite at step {state.step}")
        if (i + 1) % log_every == 0:
            snap = meters.snapshot()
            entry = {
                "step": state.step,
                "loss": loss,
                "acc": float(metrics["acc"]),
                "loss_median": meters.medians()["loss"],
                "loss_avg": snap["loss"],
                "lr": float(schedule(state.step)),
                "iter_s": timer.mean,
                "time": time.time() - t0,
            }
            history.append(entry)
            log_json_stats({"_type": "train_iter", **entry}, stats_path)
            writer.add_scalars(
                {"train/loss": snap["loss"], "train/acc": snap["acc"],
                 "train/lr": entry["lr"]},
                step=state.step,
            )
        if out_dir is not None and (i + 1) % save_period == 0:
            save("step_latest")
    if out_dir is not None:
        save("epoch_latest")
        log_json_stats(
            {"_type": "train_done", "step": state.step,
             **{f"{k}_global": v for k, v in meters.global_avgs().items()}},
            stats_path,
        )
    writer.close()
    return state, history


# -- linear eval ---------------------------------------------------------------------

def accumulate_ensemble(scores: Dict[int, np.ndarray], logits: np.ndarray,
                        video_indices, method: str = "sum") -> None:
    """Fold one batch of per-clip logits into per-video ensembled scores
    (reference ClassifyTestMeter.update_stats, utils/meters.py:578-614).

    ``max`` maxes actual scores only — the reference maxes against its
    zero-initialized buffer, silently clipping negative logits to 0
    (meters.py:561,603-606); our pipeline ensembles softmax-free logits so
    the sane init is the first view's scores. The dedup of repeated
    (video, clip) views is also not replicated: the loaders enumerate each
    view exactly once.
    """
    for j, vid in enumerate(video_indices):
        vid = int(vid)
        if method == "sum":
            scores[vid] = scores.get(vid, 0.0) + logits[j]
        elif method == "max":
            scores[vid] = (
                np.maximum(scores[vid], logits[j]) if vid in scores
                else np.asarray(logits[j], dtype=np.float64)
            )
        else:
            raise ValueError(f"unsupported ensemble method {method!r}")


def ensemble_topk(scores: Dict[int, np.ndarray],
                  labels_by_video: Dict[int, int],
                  ks: Sequence[int] = (1, 5)) -> Dict[int, float]:
    """Per-video ensembled top-k accuracies in percent (reference
    ClassifyTestMeter.finalize_metrics + metrics.topks_correct)."""
    n = len(scores)
    correct = {k: 0 for k in ks}
    for vid, sc in scores.items():
        order = np.argsort(sc)[::-1]
        label = labels_by_video[vid]
        for k in ks:
            correct[k] += int(label in order[:k])
    return {k: 100.0 * correct[k] / n for k in ks}


def make_feature_fn(backbone_variables: Dict, mode: str = "multimodal", device=None):
    """Frozen-backbone feature extractor (visual / audio / multimodal) on
    ``device``: (visual uint8 (B,T,H,W,3), audio (B,80,128,1)) -> (B, D)
    features, the backbones in eval mode under ``torch.inference_mode``."""
    if mode not in ("visual", "audio", "multimodal"):
        raise ValueError(f"unknown eval mode {mode!r} (visual|audio|multimodal)")
    device = resolve_device(device)
    nets = []
    if mode in ("visual", "multimodal"):
        nets.append(("visual_conv", VisualResNet3D()))
    if mode in ("audio", "multimodal"):
        nets.append(("audio_conv", AudioResNet2D()))
    for name, net in nets:
        net.load_state_dict(backbone_state_dict_from_flax(backbone_variables, name))
        net.to(device).eval()

    def features(visual, audio) -> torch.Tensor:
        with torch.inference_mode():
            v, a = model_inputs(visual, audio, device)
            feats = torch.cat([net(v if name == "visual_conv" else a)
                               for name, net in nets], dim=-1)
        return feats.clone()  # a normal tensor, which autograd may save

    return features


def make_head_step(head: ClassifyHead, optimizer: torch.optim.Optimizer,
                   schedule: Callable[[int], float]):
    """The linear head's train step: (feats, labels, keep mask, step) ->
    (loss, acc %) after one SGD step at lr ``schedule(step)``."""

    def step(feats, labels, mask, n: int):
        head.train()
        logits = head(feats, mask)
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(optimizer, schedule(n))
        optimizer.step()
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean() * 100.0
        return loss.detach(), acc

    return step


def linear_eval(
    backbone_variables: Dict,
    train_batches: Iterable[Dict],
    test_batches: Iterable[Dict],
    num_classes: int,
    mode: str = "multimodal",
    num_steps: int = 200,
    base_lr: float = 1e-2,
    seed: int = 0,
    log_every: int = 10,
    cache_features: bool = False,
    stats_path=None,
    device=None,
) -> Dict:
    """Train a linear head on frozen features, test with per-video score
    ensembling. Batches: {visual, audio, label, video_index}.

    ``cache_features``: run the frozen backbone over the train set ONCE and
    train the head for ``num_steps`` on the cached features. The head's
    init and its dropout masks come from a CPU ``torch.Generator`` seeded
    with ``seed``, so every device draws the same. Returns {top1, top5,
    history, params} (the head's params in the JAX package's layout)."""
    from ..utils.profiling import Meters, log_json_stats

    device = resolve_device(device)
    meters = Meters(window_size=log_every)
    feature_fn = make_feature_fn(backbone_variables, mode, device)
    schedule = lr_schedule("cosine", base_lr, num_steps)
    gen = torch.Generator().manual_seed(seed)
    head = head_step = None
    history = []
    steps = 0
    if cache_features:
        cached = [(feature_fn(b["visual"], b["audio"]), b["label"]) for b in train_batches]

        def cycle():
            while cached:
                for feats, labels in cached:
                    yield {"feats": feats, "label": labels}

        train_batches = cycle()
    for batch in train_batches:
        feats = batch["feats"] if "feats" in batch else feature_fn(
            batch["visual"], batch["audio"])
        if head is None:
            head = ClassifyHead(feats.shape[-1], num_classes)
            init_eval_weights(head, gen)
            head.to(device)
            optimizer = build_optimizer("sgd", head.named_parameters(), schedule)
            head_step = make_head_step(head, optimizer, schedule)
        mask = (torch.rand(feats.shape, generator=gen) >= head.dropout_rate).to(device)
        labels = torch.as_tensor(np.asarray(batch["label"]), dtype=torch.long).to(device)
        loss, acc = head_step(feats, labels, mask, steps)
        meters.add(loss=float(loss), acc=float(acc))
        history.append({"loss": float(loss), "acc": float(acc)})
        steps += 1
        if steps % log_every == 0:
            log_json_stats(
                {"_type": "classify_train_iter", "step": steps, **meters.snapshot()},
                stats_path,
            )
        if steps >= num_steps:
            break

    # test: sum ensemble-view scores per video (utils/meters.py:522-689)
    params = head_flax_from_state_dict(head.state_dict())["params"] if head else None
    score_sums: Dict[int, np.ndarray] = {}
    labels_by_video: Dict[int, int] = {}
    if head is not None:
        head.eval()
    for batch in test_batches:
        feats = feature_fn(batch["visual"], batch["audio"])
        with torch.inference_mode():
            logits = head(feats).cpu().numpy()
        accumulate_ensemble(score_sums, logits, batch["video_index"])
        for j, vid in enumerate(batch["video_index"]):
            labels_by_video[int(vid)] = int(batch["label"][j])
    if not score_sums:
        return {"top1": 0.0, "top5": 0.0, "history": history, "params": params}
    topk = ensemble_topk(score_sums, labels_by_video, ks=(1, 5))
    result = {"top1": topk[1], "top5": topk[5], "history": history, "params": params}
    log_json_stats(
        {"_type": "test_epoch", "top1_acc": result["top1"],
         "top5_acc": result["top5"], "num_videos": len(score_sums)},
        stats_path,
    )
    return result
