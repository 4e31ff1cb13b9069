"""Stage 4 — feature extraction (SlowFast + VGGish layer features).

Port of ``acav100m_tpu/pipeline/feature_extraction.py`` (reference
``feature_extraction/code/run_extraction.py:23-134``) with the same config
keys, defaults and file contracts: tar+json shards in, per-shard ``.pkl``
feature rows out (schema ``utils.io.make_feature_row``), ``_cache.pkl``
resume files, the ``shard_ok_ratio`` partial flush and the ``log_*.json``
run manifest.

Each batch runs every model on ``computation.device`` under
``torch.inference_mode``: normalize -> pathway pack -> SlowFast taps (the
slow ``s2`` stage through kernel K2 when ``computation.pallas_stages``,
default True here), and log-mel -> VGGish taps. The prefetch thread
decodes the next batch and stages it to the card on a side stream.

``computation.dtype`` is float32 (the default) or bfloat16, in which the
conv stacks of both models run (K2 in its bf16 form), with float32 weights
as in the JAX package; the taps are written as float32 either way.
``computation.fast_block`` (the JAX package's blocked-T fast pathway, a
layout of the same function) is validated and runs the canonical graph.
``computation.quant`` and ``equalize_length`` across processes are not
ported and raise.
"""

from __future__ import annotations

import functools
import time
from collections import OrderedDict, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, build_config
from ..data.meta import load_metadata
from ..data.tar_dataset import Prefetcher, make_loader
from ..data.video import get_decoder, prepare_clip
from ..device import resolve_device
from ..models import compute_dtype, get_model, init_weights
from ..models import slowfast as slowfast_mod
from ..models import vggish as vggish_mod
from ..utils.io import (
    load_shard_caches,
    make_feature_row,
    save_shard_cache,
    save_shard_output,
)
from ..utils.manifests import write_run_manifest
from ..utils.shards import plan_shards

DEFAULTS = {
    "models": ["layer_vggish", "layer_slowfast"],
    "model_types": {
        "audio": ["vggish", "layer_vggish"],
        "visual": ["slowfast", "layer_slowfast"],
    },
    "data": {
        "batch_size": 16,
        "media": {"path": None, "num_frames": 32, "size": 256},
        "output": {"path": "output", "shard_ok_ratio": 0.99},
        "decoder": "npz",
    },
    "computation": {
        "random_seed": 0,
        "index": 0,
        "total": 1,
        "discard_shards": False,
        "dtype": "float32",  # 'bfloat16' runs the conv stacks in bf16
        "num_workers": 0,  # decode worker processes (0 = in-process)
        "equalize_length": False,
        "fast_block": None,
        # the slow s2 stage through kernel K2 (plain version on the CPU)
        "pallas_stages": True,
        "quant": "none",
        # batches decoded and staged to the device ahead of the current one
        "device_prefetch": 2,
        "device": "cuda",
    },
    "acav": {
        "duration": 10,
        "skip_shorter_ratio": 0.25,
        "save_cache_every": 1,
    },
    "weights": {"slowfast_file": None, "vggish_file": None},
    "log_period": 1,
}


def get_config(overrides: Optional[Dict] = None) -> Config:
    return build_config(DEFAULTS, overrides, strict=True)


def load_flax_npz(path) -> Dict:
    """A converted flax tree saved as ``.npz`` ('/'-joined keys) -> nested
    numpy dicts (the JAX package's ``zoo.save_flax_npz`` format)."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def _check_supported(cfg) -> None:
    c = cfg.computation
    compute_dtype(c.dtype or "float32")
    slowfast_mod.check_fast_block(c.fast_block)
    if (c.quant or "none") != "none":
        raise NotImplementedError(f"computation.quant={c.quant} is not ported")
    if c.equalize_length and (c.total or 1) > 1:
        raise NotImplementedError("computation.equalize_length is not ported")


def build_models(cfg, device=None):
    """Instantiate the models on ``device``: weights from converted flax
    ``.npz`` trees when ``weights.*_file`` is set, else a seeded init that
    mirrors flax's (lecun-normal kernels, zero biases, BN scale 1, bias 0,
    mean 0, var 1, every block's final BN scale 0). The weights are float32
    whatever ``computation.dtype`` (the JAX package's float32 twin), which
    the models compute in."""
    _check_supported(cfg)
    c = cfg.computation
    device = resolve_device(c.device) if device is None else device
    seed = c.random_seed or 0
    dtype = compute_dtype(c.dtype or "float32")
    models = OrderedDict()
    for name in cfg.models:
        cls = get_model(name)
        video = cls.media_type == "video"
        model = (cls(pallas_stages=bool(c.pallas_stages), dtype=dtype,
                     fast_block=c.fast_block) if video else cls(dtype=dtype))
        wfile = cfg.weights.slowfast_file if video else cfg.weights.vggish_file
        if wfile and Path(wfile).is_file():
            if Path(wfile).suffix != ".npz":
                raise NotImplementedError(
                    f"{wfile}: torch/caffe2 checkpoints are not loaded yet; "
                    "convert to a flax .npz with the JAX package")
            conv = slowfast_mod if video else vggish_mod
            model.load_state_dict(conv.state_dict_from_flax(load_flax_npz(wfile)))
        else:
            init_weights(model, torch.Generator().manual_seed(seed + (0 if video else 1)))
            if video:
                slowfast_mod.zero_init_final_bn(model)
        models[name] = model.to(device).eval()
    return models


def make_extract_fn(models: Dict):
    """One function computing every model's layer taps for a batch."""

    @torch.inference_mode()
    def extract(frames, audio, valid_samples):
        out = {}
        for name, model in models.items():
            if model.media_type == "video":
                out[name] = model(frames)
            else:
                out[name] = model(audio, valid_samples)
        return out

    return extract


def _stage(batch: Dict, device, stream) -> Dict:
    """Copy a host batch's arrays to ``device``; on CUDA the copy runs on
    ``stream`` and an event marks its end."""
    batch = dict(batch)  # the loader may still hold the original dict
    arrays = [torch.from_numpy(np.asarray(batch[k]))
              for k in ("frames", "audio", "valid_samples")]
    if device.type != "cuda":
        batch["_dev"] = (arrays, None)
        return batch
    with torch.cuda.stream(stream):
        dev = [a.pin_memory().to(device, non_blocking=True) for a in arrays]
        event = torch.cuda.Event()
        event.record(stream)
    batch["_dev"] = (dev, event)
    return batch


def run_extraction(cfg, decoder=None, models=None):
    """Extract features for this process's shards. Returns saved paths."""
    device = resolve_device(cfg.computation.device)
    out_dir = Path(cfg.data.output.path)
    out_dir.mkdir(parents=True, exist_ok=True)

    mine, _ = plan_shards(
        cfg.data.media.path,
        index=cfg.computation.index or 0,
        total=cfg.computation.total or 1,
        suffix=".tar",
        discard_remainder=bool(cfg.computation.discard_shards),
    )
    metas, _ = load_metadata(mine)
    mine = [p for p in mine if Path(p).stem in metas]
    caches, skip_lists = load_shard_caches(out_dir, mine)
    # shards whose output pkl already exists are skipped entirely
    mine = [p for p in mine if not (out_dir / f"{Path(p).stem}.pkl").is_file()]

    if models is None:
        models = build_models(cfg, device)
    else:
        _check_supported(cfg)
    model_names = list(models)
    audio_keys = list(cfg.model_types.audio or [])
    extract_fn = make_extract_fn(models)

    if decoder is None:
        decoder = get_decoder(cfg.data.decoder or "npz")
    duration = cfg.acav.duration or 10
    prepare = functools.partial(
        prepare_clip,
        num_frames=cfg.data.media.num_frames or 32,
        duration=duration,
        skip_shorter_seconds=duration * (cfg.acav.skip_shorter_ratio or 0.25),
    )
    batch_size = cfg.data.batch_size or 16
    loader = make_loader(mine, metas, batch_size, skip_lists=skip_lists,
                         decoder=decoder, prepare=prepare,
                         num_workers=cfg.computation.num_workers or 0)

    rows: Dict[str, "OrderedDict[str, Dict]"] = defaultdict(OrderedDict)
    shard_sizes: Dict[str, int] = {}
    saved_paths: List[Path] = []

    # resume from caches
    for shard_name, cache in caches.items():
        for row in cache:
            rows[shard_name][Path(row["filename"]).stem] = row
            shard_sizes[shard_name] = row["shard_size"]

    def save_shard(shard_name):
        path = save_shard_output(
            list(rows[shard_name].values()), out_dir, shard_name, final=True
        )
        saved_paths.append(path)
        del rows[shard_name]
        shard_sizes.pop(shard_name, None)

    save_cache_every = cfg.acav.save_cache_every or 1
    depth = cfg.computation.device_prefetch
    if depth is None:
        depth = 2
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    staged = (_stage(b, device, stream) for b in loader)
    batches = Prefetcher(staged, depth=depth) if depth > 0 else staged

    t0 = time.time()
    for n_iter, batch in enumerate(batches):
        dev, event = batch.pop("_dev")
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in dev:  # the copies were allocated on the side stream
                t.record_stream(current)
        taps = extract_fn(*dev)
        taps = {name: [t.float().cpu().numpy() for t in tap_list]
                for name, tap_list in taps.items()}
        for i in range(len(batch["filename"])):
            if not batch["batch_mask"][i]:
                continue
            fname = batch["filename"][i]
            shard_name = batch["shard_name"][i]
            stem = Path(fname).stem
            if stem in rows[shard_name]:
                continue
            per_model = [
                {
                    "model_key": name,
                    "extractor_name": models[name].model_tag["name"],
                    "dataset": models[name].model_tag["dataset"],
                    "array": [layer[i] for layer in taps[name]],
                }
                for name in model_names
            ]
            rows[shard_name][stem] = make_feature_row(
                fname, shard_name, int(batch["shard_size"][i]), per_model,
                audio_keys,
            )
            shard_sizes[shard_name] = int(batch["shard_size"][i])
        # cache + complete-shard flush
        for shard_name in list(rows):
            if (n_iter + 1) % save_cache_every == 0:
                save_shard_cache(list(rows[shard_name].values()), out_dir, shard_name)
            if (shard_name in shard_sizes
                    and len(rows[shard_name]) >= shard_sizes[shard_name]):
                save_shard(shard_name)
        if cfg.log_period and (n_iter + 1) % cfg.log_period == 0:
            print(f"[extract idx={cfg.computation.index}] iter {n_iter + 1} "
                  f"({time.time() - t0:.1f}s)")

    # final pass: flush shards >= shard_ok_ratio complete
    ratio = cfg.data.output.shard_ok_ratio or 0.99
    for shard_name in list(rows):
        if shard_name in shard_sizes and len(rows[shard_name]) >= round(
            shard_sizes[shard_name] * ratio
        ):
            save_shard(shard_name)

    write_run_manifest(out_dir, saved_paths)
    return saved_paths
