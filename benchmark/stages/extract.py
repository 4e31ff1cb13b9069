"""Stage 4, feature extraction: ``acav100m_torch.pipeline.feature_extraction.run_extraction``.

Traffic (``traffic/<mix>.json``, kind ``extract``): ``distinct_clips``
clips made from the seed on the device (frames uint8 of the configuration's
``num_frames`` x ``size``^2 x 3, ``duration`` s of mono 16 kHz audio),
held on the host as a decoder returns them, and ``shards`` tar shards of
``members_per_shard`` members, each member naming one clip in a seeded
order, with the shard's json of ids and segments. The benchmark's decoder
maps a member to its clip, so the host's decode is not measured: the cell
stands for a host whose decoders keep up with the card.

A call extracts one shard into a fresh output directory (rows ``.pkl``,
the ``_cache.pkl`` rewritten every ``save_cache_every`` batches, the run
manifest), with the models built once at set-up from the seed's weights.
Work: clips whose rows the call wrote.

The check: rows sampled from the seed across the window's calls, each
against the plain reference (``reference/slowfast.py``,
``reference/vggish.py``) on the same clip and weights, in float32 with TF32
off. ``tap_err.<model>`` is the largest, over sampled rows and the
model's five taps, of the tap's largest absolute error over its largest
magnitude; ``tap_rms.<model>`` the largest, over the model's taps, of the
tap's root-mean-square error over its root-mean-square, over the sampled
rows together. The cell's limits file says which of the four it compares;
``rows_wrong`` counts rows missing, doubled, or not of the shard.
"""

from __future__ import annotations

import io
import json
import math
import pickle
import tarfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import weights as W
from benchmark.harness import dotted
from benchmark.reference.slowfast import SlowFastTaps
from benchmark.reference.vggish import VggishTaps

SR = 16000
MODELS = (("layer_slowfast", SlowFastTaps), ("layer_vggish", VggishTaps))


class MemoryDecoder:
    """A member's bytes (a clip's index) -> the clip as the native decoder
    hands it over: sampled uint8 frames and mono 16 kHz audio."""

    def __init__(self, frames: np.ndarray, audio: np.ndarray, fps: float):
        self.frames, self.audio, self.fps = frames, audio, fps

    def __call__(self, data: bytes) -> Dict:
        i = int(data)
        return {"frames": self.frames[i], "audio": self.audio[i], "sample_rate": SR,
                "video_fps": self.fps}


def write_shard(path: Path, names: List[str], clips: List[int]) -> None:
    with tarfile.open(path, "w") as tf:
        for name, clip in zip(names, clips):
            data = str(clip).encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    meta = [{"filename": n, "id": f"yt{c:06d}", "segment": [0.0, 10.0]}
            for n, c in zip(names, clips)]
    path.with_suffix(".json").write_text(json.dumps(meta))


class Stage:
    def __init__(self, ctx):
        self.ctx = ctx
        self.c = ctx.config["extract"]
        self.comp = ctx.config["computation"]
        self.t = ctx.traffic
        self.calls: List[Tuple[int, Path]] = []
        self.sample: List[Tuple[str, int, List[np.ndarray]]] = []
        self.wrong = 0

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from acav100m_torch.models import get_model

        self.make_traffic()
        self.models = {}
        for name, ref_cls in MODELS:
            cls = get_model(name)
            kwargs = ({"pallas_stages": self.comp["pallas_stages"],
                       "fast_block": self.comp["fast_block"], "quant": self.comp["quant"]}
                      if name == "layer_slowfast" else {})
            with torch.device("meta"):
                model = cls(dtype=self.comp["dtype"], **kwargs)
            state = W.make_state_dict(W.reference_on_meta(ref_cls), self.ctx.subseed(name),
                                      self.ctx.device)
            self.models[name] = W.load_into(model, state, self.ctx.device)
            del state
        # warm-up: one short call (one batch) at the cell's shapes
        self._extract(self.shards[-1][0], self.ctx.work / "warmup")

    def make_traffic(self) -> None:
        """The clips (host arrays) and the shards (under the work dir)."""
        ctx, c, t = self.ctx, self.c, self.t
        dev = ctx.device
        n, frames_n, size = t["distinct_clips"], c["num_frames"], c["size"]
        samples = int(c["duration"] * SR)
        gen = torch.Generator(device=dev).manual_seed(ctx.subseed("clips"))
        frames = torch.randint(0, 256, (n, frames_n, size, size, 3), generator=gen,
                               device=dev, dtype=torch.uint8)
        audio = 0.1 * torch.randn((n, samples), generator=gen, device=dev)
        self.frames, self.audio = frames.cpu().numpy(), audio.cpu().numpy()
        del frames, audio
        self.decoder = MemoryDecoder(self.frames, self.audio, frames_n / c["duration"])

        rng = np.random.default_rng(ctx.subseed("order"))
        clips_dir = ctx.work / "clips"
        clips_dir.mkdir()
        self.shards = []
        for s in range(t["shards"] + 1):
            m = t["warmup_members"] if s == t["shards"] else t["members_per_shard"]
            names = [f"v{s:03d}{j:05d}.mp4" for j in range(m)]
            clips = rng.integers(0, n, size=m).tolist()
            path = clips_dir / f"shard-{s:06d}.tar"
            write_shard(path, names, clips)
            self.shards.append((path, names, clips))

    def _extract(self, shard: Path, out: Path) -> None:
        from acav100m_torch.pipeline import feature_extraction as fe

        c = self.c
        cfg = fe.get_config(dotted({
            "data": {"batch_size": c["batch_size"], "decoder": "npz",
                     "media": {"path": str(shard), "num_frames": c["num_frames"],
                               "size": c["size"]},
                     "output": {"path": str(out)}},
            "computation": {"dtype": self.comp["dtype"], "quant": self.comp["quant"],
                            "pallas_stages": self.comp["pallas_stages"],
                            "fast_block": self.comp["fast_block"],
                            "num_workers": c["num_workers"],
                            "device": self.ctx.device.type},
            "acav": {"duration": c["duration"], "save_cache_every": c["save_cache_every"]},
            "log_period": 0,
        }))
        fe.run_extraction(cfg, decoder=self.decoder, models=self.models)
        if self.ctx.cuda:
            torch.cuda.synchronize()

    # -- the window ----------------------------------------------------------

    def call(self, i: int) -> None:
        shard = i % self.t["shards"]
        out = self.ctx.work / "out" / f"call{i:04d}"
        self._extract(self.shards[shard][0], out)
        self.calls.append((shard, out))

    def count_units(self, calls: int) -> Tuple[int, int]:
        """(clips written, clips attempted); keeps the check's sample."""
        rng = np.random.default_rng(self.ctx.subseed("check"))
        per_call = math.ceil(self.t["check_rows"] / max(calls, 1))
        units = 0
        for shard, out in self.calls:
            path, names, clips = self.shards[shard]
            by_name = {}
            pkl = out / f"{path.stem}.pkl"
            rows = pickle.loads(pkl.read_bytes()) if pkl.is_file() else []
            for row in rows:
                by_name.setdefault(row["filename"], []).append(row)
            good = [nm for nm in names if len(by_name.get(nm, ())) == 1]
            self.wrong += len(names) - len(good) + sum(
                len(v) for k, v in by_name.items() if k not in set(names))
            units += len(good)
            member = {nm: clip for nm, clip in zip(names, clips)}
            for j in rng.choice(len(good), size=min(per_call, len(good)), replace=False):
                row = by_name[good[j]][0]
                taps = []
                for side, key in (("video_features", "layer_slowfast"),
                                  ("audio_features", "layer_vggish")):
                    feat = next(f for f in row[side] if f["model_key"] == key)
                    taps += [np.asarray(feat["array"][f"layer_{k}"]) for k in range(5)]
                self.sample.append((good[j], member[good[j]], taps))
        return units, len(self.calls) * self.t["members_per_shard"]

    def layer_info(self, calls: int) -> Dict:
        c = self.c
        return {"batch_size": c["batch_size"], "slow_frames": c["num_frames"] // 4,
                "k2_hw": c["size"] // 4, "num_frames": c["num_frames"], "size": c["size"],
                "audio_seconds": c["duration"]}

    def spans(self):
        """Program layers that the traced run names idle gaps by."""
        from acav100m_torch.data import tar_dataset
        from acav100m_torch.pipeline import feature_extraction as fe

        return [(fe, "prepare_clip", "span.prepare_clip"),
                (tar_dataset, "collate", "span.collate"),
                (fe, "_stage", "span.pin_and_copy"),
                (fe, "make_feature_row", "span.make_feature_row"),
                (fe, "save_shard_cache", "span.save_shard_cache"),
                (fe, "save_shard_output", "span.save_shard_output"),
                (fe, "load_metadata", "span.load_metadata"),
                (MemoryDecoder, "__call__", "span.decode")]

    def release(self) -> None:
        self.models = None
        if self.ctx.cuda:
            torch.cuda.empty_cache()

    def close(self) -> None:
        self.models = None

    # -- the check -------------------------------------------------------------

    def reference_taps(self, clips: List[int]) -> Dict[int, List[np.ndarray]]:
        """The plain reference's ten taps of each clip, in blocks of 4."""
        dev = self.ctx.device
        refs = {}
        for name, ref_cls in MODELS:
            state = W.make_state_dict(W.reference_on_meta(ref_cls), self.ctx.subseed(name), dev)
            refs[name] = W.load_into(W.reference_on_meta(ref_cls), state, dev)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        out: Dict[int, List[np.ndarray]] = {}
        try:
            with torch.inference_mode():
                for k in range(0, len(clips), 4):
                    block = clips[k:k + 4]
                    frames = torch.from_numpy(self.frames[block]).to(dev)
                    audio = torch.from_numpy(self.audio[block]).to(dev)
                    valid = torch.full((len(block),), audio.shape[1], device=dev)
                    taps = (refs["layer_slowfast"](frames)
                            + refs["layer_vggish"](audio, valid))
                    for b, clip in enumerate(block):
                        out[clip] = [t[b].double().cpu().numpy() for t in taps]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return out

    def check(self, calls: int) -> List[Tuple[str, float, float]]:
        lim = self.ctx.limits
        clips = sorted({clip for _, clip, _ in self.sample})
        ref = self.reference_taps(clips)
        errs, sq = [0.0] * 10, np.zeros((2, 10))
        for _, clip, taps in self.sample:
            for t, (got, want) in enumerate(zip(taps, ref[clip])):
                scale = max(float(np.abs(want).max()), 1e-30)
                e = float(np.abs(got - want).max()) / scale
                errs[t] = max(errs[t], e if math.isfinite(e) else math.inf)
                sq[0, t] += float(((got - want) ** 2).sum())
                sq[1, t] += float((want ** 2).sum())
        rms = np.sqrt(sq[0] / np.maximum(sq[1], 1e-300)).tolist()
        if not self.sample:
            errs = rms = [math.inf] * 10
        rms = [v if math.isfinite(v) else math.inf for v in rms]  # a NaN would pass a limit
        self.detail = {"tap_err_by_tap": errs, "tap_rms_by_tap": rms}
        numbers = {"tap_err.slowfast": max(errs[:5]), "tap_err.vggish": max(errs[5:]),
                   "tap_rms.slowfast": max(rms[:5]), "tap_rms.vggish": max(rms[5:])}
        return [(name, value, lim[name]) for name, value in numbers.items() if name in lim] + [
            ("rows_wrong", float(self.wrong), 0.0)]
