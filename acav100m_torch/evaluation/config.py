"""YAML/JSON config surface for the evaluation suite, the counterpart of
``acav100m_tpu/evaluation/config.py``: the same keys and defaults, plus
``computation.device`` (default ``cuda``, which raises without a card;
``computation.device=cpu`` runs on the CPU), as every stage of the port has.

The reference specifies its experiments through fvcore ``CfgNode`` YAML
files plus CLI opts (``evaluation/code/config.py:24-560``,
``configs/{acav,ucf101,esc50,kinetics-sounds}/config.yaml``); this is the
equivalent here: a nested-defaults tree merged from a YAML/JSON file and
dotted-key overrides through the package's one strict config system, then
dispatched to the pretrain / linear-eval task functions.

    python -m acav100m_torch evaluate --cfg configs/acav_pretrain.yaml \
        train.num_steps=100 checkpoint.dir=runs/acav

Keys mirror the reference's groups (TRAIN/TEST/DATA/SOLVER →
train/eval/data/checkpoint) at the scale of this rebuild's task functions.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config import Config, build_config
from ..device import resolve_device

DEFAULTS = {
    "task": "pretrain",  # pretrain | linear_eval
    "data": {
        # pretrain: tar-shard spec (stage-3 contract); linear_eval: a
        # ClipClassificationDataset directory (npz clips + labels.json)
        "path": None,
        "batch_size": 4,
        "num_frames": 8,
        "crop": 112,
        "num_ensemble_views": 2,
        "num_spatial_crops": 1,  # 3 = reference TEST.NUM_SPATIAL_CROPS
    },
    "train": {
        "num_steps": 100,
        "base_lr": 1e-3,
        "warmup_steps": 0,
        "save_period": 100,
        "log_every": 10,
    },
    "eval": {
        "mode": "multimodal",  # visual | audio | multimodal
        "num_classes": None,   # None -> len(labels.json classes)
        "num_steps": 200,
        "base_lr": 1e-2,
        # protocol: None = single flat split; "splits" = UCF101-style
        # official-split averaging; "folds" = ESC-50-style k-fold CV
        "protocol": None,
        "num_splits": 3,
        "num_folds": 5,
        # cache frozen-backbone train features once and train the head on
        # the cache (multi-epoch head training without re-running the
        # backbone; freezes train-view augmentation to one draw)
        "cache_features": False,
    },
    "checkpoint": {"dir": None, "pretrained": None},
    "tensorboard": {"dir": None},
    "computation": {"random_seed": 0, "device": "cuda"},
}


def load_config(cfg_file=None, overrides: Optional[Dict] = None) -> Config:
    """YAML/JSON file + dotted-key overrides -> strict Config.

    File values are applied as dotted overrides onto the defaults, so
    unknown keys error exactly like CLI overrides do.
    """
    merged: Dict = {}
    if cfg_file is not None:
        text = Path(cfg_file).read_text()
        if str(cfg_file).endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(text) or {}
        else:
            data = json.loads(text)
        merged.update(_flatten(data))
    if overrides:
        merged.update(overrides)
    return build_config(DEFAULTS, merged, strict=True)


def _flatten(tree: Dict, prefix: str = "") -> Dict:
    flat: Dict = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def run_task(cfg: Config) -> Dict:
    """Dispatch a config to its task function; returns a result dict."""
    from . import train as et

    device = resolve_device(cfg.computation.device)
    rng = np.random.RandomState(cfg.computation.random_seed or 0)
    if cfg.task == "pretrain":
        from ..data.meta import load_metadata
        from ..utils.braceexpand import braceexpand
        from .data import pretrain_batches

        shards = [Path(p) for p in sorted(braceexpand(str(cfg.data.path)))]
        shards = [p for p in shards if p.is_file()]
        metas, _ = load_metadata(shards)
        batches = pretrain_batches(
            shards, metas, cfg.data.batch_size, rng,
            num_frames=cfg.data.num_frames, crop=cfg.data.crop,
        )
        state, history = et.pretrain(
            batches,
            num_steps=cfg.train.num_steps,
            out_dir=cfg.checkpoint.dir,
            save_period=cfg.train.save_period,
            base_lr=cfg.train.base_lr,
            warmup_steps=cfg.train.warmup_steps,
            seed=cfg.computation.random_seed or 0,
            log_every=cfg.train.log_every,
            tb_dir=cfg.tensorboard.dir,
            device=device,
        )
        return {"task": "pretrain", "steps": int(state.step),
                "history": history}
    if cfg.task == "linear_eval":
        if cfg.eval.protocol:
            return run_protocol(cfg)
        result = _linear_eval_once(cfg, rng, device=device)
        return {"task": "linear_eval", "top1": result["top1"],
                "top5": result["top5"]}
    raise ValueError(f"unknown task {cfg.task!r} (pretrain|linear_eval)")


def _linear_eval_once(cfg: Config, rng, split_id: Optional[int] = None,
                      fold: Optional[int] = None, device=None) -> Dict:
    """One frozen-backbone linear eval on one train/test partition."""
    from . import train as et
    from .data import ClipClassificationDataset

    if not cfg.checkpoint.pretrained:
        raise ValueError("linear_eval needs checkpoint.pretrained")
    backbone = et.load_pretrained_backbone(cfg.checkpoint.pretrained)
    root = Path(cfg.data.path)
    train_ds = ClipClassificationDataset(
        root, "train", split_id=split_id, fold=fold)
    test_ds = ClipClassificationDataset(
        root, "test",
        num_ensemble_views=cfg.data.num_ensemble_views,
        num_spatial_crops=cfg.data.num_spatial_crops,
        split_id=split_id, fold=fold,
    )
    num_classes = cfg.eval.num_classes or len(train_ds.classes)

    def batches(ds, reps):
        for _ in range(reps):
            buf = []
            for ex in ds.examples(rng, cfg.data.num_frames, cfg.data.crop):
                buf.append(ex)
                if len(buf) == cfg.data.batch_size:
                    yield _collate_classify(buf)
                    buf = []
            if buf:
                yield _collate_classify(buf)

    reps = max(1, -(-cfg.eval.num_steps * cfg.data.batch_size
                    // max(len(train_ds), 1)))
    if cfg.eval.cache_features:
        reps = 1  # one pass materializes the cache; the head loops on it
    return et.linear_eval(
        backbone,
        batches(train_ds, reps),
        batches(test_ds, 1),
        num_classes=num_classes,
        mode=cfg.eval.mode,
        num_steps=cfg.eval.num_steps,
        base_lr=cfg.eval.base_lr,
        log_every=cfg.train.log_every,
        cache_features=bool(cfg.eval.cache_features),
        stats_path=(Path(cfg.checkpoint.dir) / "stats.jsonl"
                    if cfg.checkpoint.dir else None),
        device=device,
    )


def run_protocol(cfg: Config) -> Dict:
    """Reference downstream evaluation protocol orchestration.

    * ``eval.protocol="splits"``: UCF101-style — run linear eval on each of
      the ``num_splits`` official train/test splits, report per-split and
      split-averaged top-1/top-5 (the BASELINE.md numbers are split
      averages; ``evaluation/README.md:75``).
    * ``eval.protocol="folds"``: ESC-50-style — ``num_folds``-fold cross
      validation (fold i is the test set), fold-averaged accuracies
      (``data/esc50.py:17-188``).
    """
    device = resolve_device(cfg.computation.device)
    rng = np.random.RandomState(cfg.computation.random_seed or 0)
    protocol = cfg.eval.protocol
    if protocol == "splits":
        runs = [("split", i) for i in range(1, (cfg.eval.num_splits or 3) + 1)]
    elif protocol == "folds":
        runs = [("fold", i) for i in range(1, (cfg.eval.num_folds or 5) + 1)]
    else:
        raise ValueError(f"unknown eval.protocol {protocol!r} (splits|folds)")
    per_run = {}
    for kind, i in runs:
        result = _linear_eval_once(
            cfg, rng,
            split_id=i if kind == "split" else None,
            fold=i if kind == "fold" else None,
            device=device,
        )
        per_run[f"{kind}{i}"] = {"top1": result["top1"], "top5": result["top5"]}
    top1 = float(np.mean([r["top1"] for r in per_run.values()]))
    top5 = float(np.mean([r["top5"] for r in per_run.values()]))
    return {
        "task": "linear_eval",
        "protocol": protocol,
        "per_run": per_run,
        # split/fold-averaged, the BASELINE.md table format
        "top1": top1,
        "top5": top5,
    }


def _collate_classify(buf):
    return {
        "visual": np.stack([e["visual"] for e in buf]),
        "audio": np.stack([e["audio_logmel"] for e in buf])[..., None],
        "label": np.asarray([e["label"] for e in buf]),
        "video_index": np.asarray([e["video_index"] for e in buf]),
    }
