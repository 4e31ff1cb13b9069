"""Stage 4 on mp4 shards: ``run_extraction`` with ``data.decoder=opencv``,
the host's decode in the window. Everything else as ``stages/extract.py``
(whose window loop, row count and check this reuses).

Traffic (``traffic/<mix>.json``, stage ``extract_mp4``): ``distinct_clips``
mp4 clips of ``duration`` s, ``width`` x ``height`` at ``fps``, written once
at set-up with OpenCV's ``mp4v`` encoder (in ``encode_threads`` threads:
OpenCV leaves the GIL while it encodes). Each clip is seeded moving content,
not per-pixel noise, so that its bitrate is a video's: a smooth background
(a coarse seeded noise field scaled up) panning at a seeded speed, with a few
seeded rectangles moving across it. ``shards`` tar shards of
``members_per_shard`` members, each member the mp4 bytes of one clip in a
seeded order, with the shard's json of ids and segments, and a warm-up shard
of ``warmup_members``. A call extracts one shard into a fresh output
directory, as ``stages/extract.py``'s calls do, with ``num_workers`` decode
workers asked for (``"cores-1"``: the host's cores less one); the program
starts them one a shard, as the reference's DataLoader splits shards among
its workers, so a one-shard call decodes in-process. OpenCV gives no audio,
so each clip's audio is silent. Work: clips whose rows the call wrote.

The check decodes each sampled member again with the same decoder and
``prepare_clip``, and holds the row against the plain references on those
frames and that audio, as ``stages/extract.py`` does.
"""

from __future__ import annotations

import json
import os
import tarfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import dotted
from benchmark.stages import extract


def encode_clip(path: Path, seed: int, seconds: float, fps: float, width: int,
                height: int) -> None:
    """One seeded clip of moving content written as mp4v."""
    import cv2

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (9, 16, 3)).astype(np.uint8)
    # twice the frame's width, so that a pan of up to a frame wraps smoothly
    field = cv2.resize(np.concatenate([coarse, coarse[:, :1]], 1), (2 * width, height),
                       interpolation=cv2.INTER_CUBIC)
    pan = int(rng.integers(1, 6))
    boxes = []
    for _ in range(4):
        bw, bh = int(rng.integers(width // 16, width // 5)), int(rng.integers(height // 12, height // 4))
        boxes.append((int(rng.integers(0, width - bw)), int(rng.integers(0, height - bh)),
                      int(rng.integers(-6, 7)), int(rng.integers(-4, 5)), bw, bh,
                      tuple(int(c) for c in rng.integers(0, 256, 3))))
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    try:
        for f in range(int(round(seconds * fps))):
            x0 = (f * pan) % width
            frame = np.ascontiguousarray(field[:, x0:x0 + width])
            for bx, by, vx, vy, bw, bh, color in boxes:
                x = (bx + vx * f) % (width - bw)
                y = (by + vy * f) % (height - bh)
                frame[y:y + bh, x:x + bw] = color
            writer.write(frame)
    finally:
        writer.release()


def num_workers(spec) -> int:
    if spec == "cores-1":
        return max(len(os.sched_getaffinity(0)) - 1, 1)
    return int(spec)


class Stage(extract.Stage):
    def make_traffic(self) -> None:
        """The mp4 clips (under the work dir) and the shards."""
        ctx, c, t = self.ctx, self.c, self.t
        clips_dir = ctx.work / "clips"
        mp4_dir = ctx.work / "mp4"
        clips_dir.mkdir()
        mp4_dir.mkdir()
        n = t["distinct_clips"]
        paths = [mp4_dir / f"clip{i:04d}.mp4" for i in range(n)]
        seeds = np.random.default_rng(ctx.subseed("clips")).integers(0, 2 ** 31, n)
        with ThreadPoolExecutor(num_workers(t["encode_threads"])) as pool:
            list(pool.map(lambda a: encode_clip(a[0], int(a[1]), c["duration"], t["fps"],
                                                t["width"], t["height"]), zip(paths, seeds)))
        self.mp4 = [p.read_bytes() for p in paths]
        rng = np.random.default_rng(ctx.subseed("order"))
        self.shards = []
        for s in range(t["shards"] + 1):
            m = t["warmup_members"] if s == t["shards"] else t["members_per_shard"]
            names = [f"v{s:03d}{j:05d}.mp4" for j in range(m)]
            clips = rng.integers(0, n, size=m).tolist()
            path = clips_dir / f"shard-{s:06d}.tar"
            with tarfile.open(path, "w") as tf:
                for name, clip in zip(names, clips):
                    tf.add(paths[clip], arcname=name)
            meta = [{"filename": nm, "id": f"yt{cl:06d}", "segment": [0.0, c["duration"]]}
                    for nm, cl in zip(names, clips)]
            path.with_suffix(".json").write_text(json.dumps(meta))
            self.shards.append((path, names, clips))
        self.decoder = None

    def _extract(self, shard: Path, out: Path) -> None:
        from acav100m_torch.pipeline import feature_extraction as fe

        c = self.c
        cfg = fe.get_config(dotted({
            "data": {"batch_size": c["batch_size"], "decoder": self.t["decoder"],
                     "media": {"path": str(shard), "num_frames": c["num_frames"],
                               "size": c["size"]},
                     "output": {"path": str(out)}},
            "computation": {"dtype": self.comp["dtype"], "quant": self.comp["quant"],
                            "pallas_stages": self.comp["pallas_stages"],
                            "fast_block": self.comp["fast_block"],
                            "num_workers": num_workers(self.t["num_workers"]),
                            "device": self.ctx.device.type},
            "acav": {"duration": c["duration"], "save_cache_every": c["save_cache_every"]},
            "log_period": 0,
        }))
        fe.run_extraction(cfg, models=self.models)
        if self.ctx.cuda:
            torch.cuda.synchronize()

    def decoded(self, clips: List[int]) -> Dict[int, Dict]:
        """The clips as the program's decoder and ``prepare_clip`` give them."""
        from acav100m_torch.data.video import get_decoder, prepare_clip

        c = self.c
        decoder = get_decoder(self.t["decoder"], size=c["size"], sample_rate=extract.SR)
        return {clip: prepare_clip(decoder(self.mp4[clip]), num_frames=c["num_frames"],
                                   duration=c["duration"],
                                   skip_shorter_seconds=c["duration"] * 0.25)
                for clip in clips}

    def reference_taps(self, clips: List[int]) -> Dict[int, List[np.ndarray]]:
        """The plain reference's ten taps of each clip, in blocks of 4, on
        the frames and audio decoded again."""
        from benchmark import weights as W

        dev = self.ctx.device
        refs = {}
        for name, ref_cls in extract.MODELS:
            state = W.make_state_dict(W.reference_on_meta(ref_cls), self.ctx.subseed(name), dev)
            refs[name] = W.load_into(W.reference_on_meta(ref_cls), state, dev)
        samples = self.decoded(clips)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        out: Dict[int, List[np.ndarray]] = {}
        try:
            with torch.inference_mode():
                for k in range(0, len(clips), 4):
                    block = clips[k:k + 4]
                    frames = torch.from_numpy(np.stack([samples[i]["frames"] for i in block])).to(dev)
                    audio = torch.from_numpy(np.stack([samples[i]["audio"] for i in block])).to(dev)
                    valid = torch.tensor([samples[i]["valid_samples"] for i in block], device=dev)
                    taps = (refs["layer_slowfast"](frames)
                            + refs["layer_vggish"](audio, valid))
                    for b, clip in enumerate(block):
                        out[clip] = [t[b].double().cpu().numpy() for t in taps]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return out
