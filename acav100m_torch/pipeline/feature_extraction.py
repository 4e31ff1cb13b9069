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
``data.decoder`` picks the clip decoder (``npz``, ``native`` for mp4 through
FFmpeg's libraries, ``ffmpeg``, ``opencv`` or ``auto``) and
``computation.num_workers`` > 0 decodes in that many spawned processes.
``weights.*_file`` takes a converted flax ``.npz`` or the published
checkpoints (PySlowFast ``.pyth``/``.pt``/``.pth``, caffe2 ``.pkl``,
torchvggish ``.pth``), each loaded through its flax tree
(``models.zoo``). ``computation.quant`` is not ported and raises.

Data parallel: with ``group=`` (a ``runtime.Group``) each rank extracts its
own shards, ``plan_shards(index=rank, total=world)`` as in the reference;
without one, ``computation.index``/``total`` place the process. With
``computation.equalize_length`` and more than one process, every process
runs the same number of steps, counted by ``get_length`` from all shards'
metadata, and a process whose shards run short steps through all-masked
batches that write no rows. Ranks exchange nothing per step (the one
collective is the closing barrier), so such a batch is neither copied to
the card nor run through the models: it costs a step of bookkeeping
(cache saves, the log line) and no card time. The JAX package also shards one
batch over the devices of a mesh inside one program
(``make_extract_fn(models, mesh)``); that has no counterpart here: a rank
per card replaces it.
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
from ..data.tar_dataset import Prefetcher, empty_batch, make_loader
from ..data.video import get_decoder, prepare_clip
from ..device import resolve_device
from ..models import compute_dtype, get_model, init_weights, zoo
from ..models import slowfast as slowfast_mod
from ..models import vggish as vggish_mod
from ..runtime import Group, barrier, group_device, placement
from ..utils.io import (
    load_shard_caches,
    make_feature_row,
    save_shard_cache,
    save_shard_output,
)
from ..utils.manifests import write_run_manifest
from ..utils.shards import get_length, plan_shards

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


def _load_weights_file(wfile, model: str) -> Dict:
    """A weights file -> the JAX package's flax tree for ``model``
    (``slowfast`` or ``vggish``): converted ``.npz`` trees load directly,
    torch and caffe2 checkpoints convert on the fly, as ``convert`` would.
    Keys the taps do not use (heads, optimizer state, ``num_batches_tracked``)
    are left behind."""
    wfile = Path(wfile)
    if wfile.suffix == ".npz":
        return zoo.load_flax_npz(wfile)
    sd = zoo.load_torch_checkpoint(wfile)
    if model == "slowfast":
        if zoo.is_caffe2(sd):
            sd = zoo.caffe2_to_pyslowfast(sd)
        return slowfast_mod.convert_pyslowfast_state_dict(sd)
    return vggish_mod.convert_torch_state_dict(sd)


def _check_supported(cfg) -> None:
    c = cfg.computation
    compute_dtype(c.dtype or "float32")
    slowfast_mod.check_fast_block(c.fast_block)
    if (c.quant or "none") != "none":
        raise NotImplementedError(f"computation.quant={c.quant} is not ported")


def build_models(cfg, device=None):
    """Instantiate the models on ``device``: weights from ``weights.*_file``
    when set (``_load_weights_file``), else a seeded init that
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
            conv = slowfast_mod if video else vggish_mod
            tree = _load_weights_file(wfile, "slowfast" if video else "vggish")
            model.load_state_dict(conv.state_dict_from_flax(tree))
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
    ``stream`` and an event marks its end. An all-masked batch (an
    ``equalize_length`` pad) writes no rows and is not copied."""
    batch = dict(batch)  # the loader may still hold the original dict
    if not np.any(batch["batch_mask"]):
        batch["_dev"] = None
        return batch
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


def run_extraction(cfg, decoder=None, models=None, group: Optional[Group] = None):
    """Extract features for this process's shards. Returns saved paths."""
    device = group_device(cfg.computation.device, group)
    out_dir = Path(cfg.data.output.path)
    out_dir.mkdir(parents=True, exist_ok=True)

    index, total = placement(cfg.computation.index, cfg.computation.total, group)
    mine, all_shards = plan_shards(
        cfg.data.media.path,
        index=index,
        total=total,
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
        name = cfg.data.decoder or "npz"
        kwargs = {}
        if name != "npz":
            kwargs["size"] = cfg.data.media.size or 256
            kwargs["sample_rate"] = 16000
        if name in ("native", "auto"):
            # sampled in C: the frames temporal_sampling would keep, but the
            # others skip scaling and storage
            kwargs["sample_frames"] = cfg.data.media.num_frames or 32
        decoder = get_decoder(name, **kwargs)
    duration = cfg.acav.duration or 10
    # a partial of a module-level function pickles for the decode workers
    prepare = functools.partial(
        prepare_clip,
        num_frames=cfg.data.media.num_frames or 32,
        duration=duration,
        skip_shorter_seconds=duration * (cfg.acav.skip_shorter_ratio or 0.25),
    )
    batch_size = cfg.data.batch_size or 16
    num_workers = cfg.computation.num_workers or 0
    pad_to_batches = pad_template = None
    if cfg.computation.equalize_length and total > 1:
        # the same count on every process: from all shards' metadata
        # (reference ResizedDataset + get_length, mps/distributed.py:444-461)
        metas_all, _ = load_metadata(all_shards)
        sizes_all = [len(metas_all[Path(p).stem]) for p in all_shards
                     if Path(p).stem in metas_all]
        pad_to_batches = get_length(sizes_all, batch_size, num_workers, total) // batch_size
        pad_template = empty_batch(batch_size, num_frames=cfg.data.media.num_frames or 32,
                                   size=cfg.data.media.size or 256)
    loader = make_loader(mine, metas, batch_size, skip_lists=skip_lists,
                         decoder=decoder, prepare=prepare, num_workers=num_workers,
                         pad_to_batches=pad_to_batches, pad_template=pad_template)

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
        staged = batch.pop("_dev")
        if staged is not None:
            dev, event = staged
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
            print(f"[extract idx={index}] iter {n_iter + 1} "
                  f"({time.time() - t0:.1f}s)")

    # final pass: flush shards >= shard_ok_ratio complete
    ratio = cfg.data.output.shard_ok_ratio or 0.99
    for shard_name in list(rows):
        if shard_name in shard_sizes and len(rows[shard_name]) >= round(
            shard_sizes[shard_name] * ratio
        ):
            save_shard(shard_name)

    write_run_manifest(out_dir, saved_paths)
    barrier(group)
    return saved_paths
