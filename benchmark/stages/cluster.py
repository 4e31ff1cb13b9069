"""Stage 5, clustering: ``acav100m_torch.pipeline.clustering.run_clustering``.

Traffic (kind ``cluster``): ``shards`` feature pkls of ``rows_per_shard``
rows in stage 4's schema, with the ten taps at the configuration's widths.
Each row takes one latent component of ``components``; each tap is that
component's mean (gaussian, spread so that two means lie ``separation``
noise widths apart) plus unit gaussian noise, made on the device from the
seed and written once at set-up. A call trains the configuration's
k-means (K, epochs, batch) over all the shards and assigns every row, into
a fresh output directory, so no centroid cache is resumed. Work: rows the
call assigned.

The check. Every training step of one call drawn from the seed is judged
from the program's own state before it (the harness keeps the program's
states, which the stage does not return, by wrapping
``ops.kmeans.train_step``): the reference (``reference/kmeans.py``, float64)
takes that state and the batch it builds itself from the rows through the
same shuffle, and steps once. ``init_diff``: the first state against the
reference's own seeded draw (exact). ``center_gap``:
the 95th percentile over the centers of each center's largest error over
its clustering's largest center, the largest by step (a near-tie that
rounding decides moves two centers of a step, which the percentile
passes). ``assign_gap``: over every row and clustering of the call's
assignment pkls, how far the assigned center's float64 distance (to the
program's final centers) lies above the nearest one's, over the mean
nearest distance. ``rows_wrong``: rows missing, doubled or misnamed.
"""

from __future__ import annotations

import math
import pickle
import random
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import dotted
from benchmark.reference import kmeans as ref

TAPS = (("layer_slowfast", "video_features"), ("layer_vggish", "audio_features"))


def worst(a: float, b: float) -> float:
    """The larger reading, a NaN (which would pass any limit) as infinity."""
    return max(a, b) if math.isfinite(b) else math.inf


class Stage:
    def __init__(self, ctx):
        self.ctx = ctx
        self.c = ctx.config["cluster"]
        self.t = ctx.traffic
        models = ctx.config["models"]
        # (model key, layer) sorted, as the program orders its clusterings
        self.types = sorted((key, f"layer_{i}") for key, _ in TAPS
                            for i in range(len(models[key]["tap_dims"])))
        self.dims = [models[key]["tap_dims"][int(layer[6:])] for key, layer in self.types]
        self.calls: List[Path] = []
        self.records: Dict[int, List] = {}
        self.recording = None
        self.wrong = 0

    def setup(self) -> None:
        self.make_traffic()
        from acav100m_torch.ops import kmeans

        self._kmeans = kmeans
        # the program's step; faults.py may put a broken one in its place
        self._train_step = self._orig_step = kmeans.train_step

        def recording_step(state, batch, lr, *args, **kwargs):
            new, mean_dist = self._train_step(state, batch, lr, *args, **kwargs)
            if self.recording is not None:
                self.records[self.recording].append(
                    (state.centers, state.counts, state.count, new.centers, new.counts))
            return new, mean_dist

        kmeans.train_step = recording_step
        # warm-up: one short call (two shards) at the cell's shapes
        self._cluster(self.spec.replace(f"{self.t['shards'] - 1:06d}}}", "000001}"),
                      self.ctx.work / "warmup")

    def make_traffic(self) -> None:
        """The rows (host arrays) and the feature pkls (under the work dir)."""
        ctx, t = self.ctx, self.t
        dev = ctx.device
        n = t["shards"] * t["rows_per_shard"]
        gen = torch.Generator(device=dev).manual_seed(ctx.subseed("features"))
        z = torch.randint(0, t["components"], (n,), generator=gen, device=dev)
        self.x = []  # per clustering (n, dim) float32, host
        for d in self.dims:
            means = torch.randn((t["components"], d), generator=gen, device=dev)
            means *= t["separation"] / math.sqrt(2 * d)
            self.x.append((means[z] + torch.randn((n, d), generator=gen, device=dev))
                          .cpu().numpy())
        feat_dir = ctx.work / "features"
        feat_dir.mkdir()
        names = {"layer_slowfast": ("SLOWFAST_8x8_R50", "kinetics-400"),
                 "layer_vggish": ("VGGish", "YouTube-8M")}
        col = {ty: i for i, ty in enumerate(self.types)}
        self.names = []
        for s in range(t["shards"]):
            rows, shard = [], f"shard-{s:06d}"
            for j in range(t["rows_per_shard"]):
                g = s * t["rows_per_shard"] + j
                row = {"filename": f"v{g:06d}.mp4", "shard_name": shard,
                       "shard_size": t["rows_per_shard"], "video_features": [],
                       "audio_features": []}
                for key, side in TAPS:
                    row[side].append({
                        "model_key": key, "extractor_name": names[key][0],
                        "dataset": names[key][1],
                        "array": {layer: self.x[col[(k2, layer)]][g]
                                  for k2, layer in self.types if k2 == key}})
                rows.append(row)
                self.names.append((shard, row["filename"]))
            with open(feat_dir / f"{shard}.pkl", "wb") as f:
                pickle.dump(rows, f)
        self.spec = str(feat_dir / f"shard-{{000000..{t['shards'] - 1:06d}}}.pkl")

    def _cluster(self, spec: str, out: Path) -> None:
        from acav100m_torch.pipeline import clustering

        c = self.c
        cfg = clustering.get_config(dotted({
            "data": {"path": spec, "batch_size": c["batch_size"], "output": {"path": str(out)}},
            "computation": {"random_seed": self.ctx.subseed("program"),
                            "use_pallas": c["use_pallas"], "device": self.ctx.device.type},
            "clustering": {"ncentroids": c["ncentroids"], "epochs": c["epochs"]},
            "log_period": 0,
        }))
        clustering.run_clustering(cfg)
        if self.ctx.cuda:
            torch.cuda.synchronize()

    def call(self, i: int) -> None:
        out = self.ctx.work / "out" / f"call{i:04d}"
        if i < 2:  # the check's call is one of the first two
            self.recording = i
            self.records[i] = []
        try:
            self._cluster(self.spec, out)
        finally:
            self.recording = None
        self.calls.append(out)

    def _assignments(self, out: Path) -> Tuple[np.ndarray, int]:
        """(rows, M) assignments of one call in row order, and the count of
        rows missing, doubled or misnamed."""
        n = len(self.names)
        got = np.full((n, len(self.types)), -1, np.int64)
        index = {name: g for g, name in enumerate(self.names)}
        seen = np.zeros(n, np.int64)
        wrong = 0
        for s in range(self.t["shards"]):
            path = out / f"shard-{s:06d}.pkl"
            rows = pickle.loads(path.read_bytes()) if path.is_file() else []
            for row in rows:
                g = index.get((row["shard_name"], row["filename"]))
                if g is None:
                    wrong += 1
                    continue
                seen[g] += 1
                arr = {}
                for side in ("video_assignments", "audio_assignments"):
                    for f in row[side]:
                        for layer, v in f["array"].items():
                            arr[(f["model_key"], layer)] = v
                got[g] = [arr.get(ty, -1) for ty in self.types]
        wrong += int((seen != 1).sum())
        return got, wrong

    def count_units(self, calls: int) -> Tuple[int, int]:
        units = 0
        self.assigned = {}
        for i, out in enumerate(self.calls):
            got, wrong = self._assignments(out)
            self.wrong += wrong
            units += len(self.names) - wrong
            if i in self.records:
                self.assigned[i] = got
        return max(units, 0), len(self.calls) * len(self.names)

    def layer_info(self, calls: int) -> Dict:
        c, n = self.c, len(self.names)
        return {"batch_size": c["batch_size"], "dims": self.dims, "k": c["ncentroids"],
                "train_steps": calls * c["epochs"] * (n // c["batch_size"]),
                "assign_batches": calls * self.t["shards"] * math.ceil(
                    self.t["rows_per_shard"] / c["batch_size"]),
                "assign_rows": calls * n}

    def spans(self):
        """Program layers that the traced run names idle gaps by."""
        from acav100m_torch.pipeline import clustering

        return [(clustering, "stack_batch", "span.stack_batch"),
                (clustering, "load_pickle", "span.load_pickle"),
                (clustering, "dump_pickle", "span.dump_pickle"),
                (clustering, "buffered_shuffle", "span.buffered_shuffle")]

    def release(self) -> None:
        """Keep only the checked call's states, on the host."""
        pick = self.ctx.subseed("check") % max(1, min(2, len(self.records)))
        self.records = {pick: [tuple(v.cpu() if torch.is_tensor(v) else v for v in rec)
                               for rec in self.records.get(pick, [])]}
        self.check_call = pick
        if self.ctx.cuda:
            torch.cuda.empty_cache()

    def close(self) -> None:
        if getattr(self, "_orig_step", None) is not None:
            self._kmeans.train_step = self._orig_step

    # -- the check -------------------------------------------------------------

    def batches(self):
        """The reference's own stream of (epoch, row indices) batches."""
        c = self.c
        rng = random.Random(self.ctx.subseed("program"))
        for epoch in range(c["epochs"]):
            buf = []
            for g in ref.buffered_shuffle(range(len(self.names)), 1000, rng):
                buf.append(g)
                if len(buf) == c["batch_size"]:
                    yield epoch, buf
                    buf = []

    def check(self, calls: int) -> List[Tuple[str, float, float]]:
        lim, c, dev = self.ctx.limits, self.c, self.ctx.device
        records = self.records[self.check_call]
        m, dmax, k = len(self.dims), max(self.dims), c["ncentroids"]
        mask = torch.zeros((m, dmax), dtype=torch.float64, device=dev)
        for i, d in enumerate(self.dims):
            mask[i, :d] = 1.0
        init = torch.rand((m, k, dmax), generator=torch.Generator().manual_seed(
            self.ctx.subseed("program")), dtype=torch.float32) * 1e-5
        init = init * mask.float().cpu()[:, None, :]
        init_diff = (float((records[0][0] - init).abs().max()) if records else math.inf)

        warm_gen = torch.Generator().manual_seed(self.ctx.subseed("program") + 1)
        flip, gap = 0.0, 0.0
        steps = list(self.batches())
        if len(steps) != len(records):
            flip = gap = math.inf
        for (epoch, rows), (c_in, n_in, count, c_out, n_out) in zip(steps, records):
            x = torch.zeros((m, len(rows), dmax), dtype=torch.float64, device=dev)
            for i, d in enumerate(self.dims):
                x[i, :, :d] = torch.from_numpy(self.x[i][rows]).to(dev, torch.float64)
            rand = (torch.rand((m, k, len(rows)), generator=warm_gen)
                    if count < ref.INITIAL_ROUNDS * k else None)
            want, added = ref.step(c_in.to(dev, torch.float64), n_in.to(dev, torch.float64),
                                   count, x, ref.lr(epoch), rand, mask)
            got_added = (n_out - n_in).to(dev, torch.float64)
            flip = worst(flip, float((got_added - added).abs().sum()) / 2 / (m * len(rows)))
            scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-300)[:, :, 0]
            err = (c_out.to(dev, torch.float64) - want).abs().amax(-1) / scale  # (M, K)
            gap = worst(gap, float(torch.quantile(err.flatten(), 0.95)))

        assign_gap = math.inf
        if records:
            _, _, _, c_fin, n_fin = records[-1]
            count = records[-1][2] + c["batch_size"]
            got = self.assigned.get(self.check_call)
            assign_gap = 0.0
            for i, d in enumerate(self.dims):
                xi = torch.from_numpy(self.x[i]).to(dev, torch.float64)[None]
                dist = ref.distances(c_fin[i:i + 1, :, :d].to(dev, torch.float64),
                                     n_fin[i:i + 1].to(dev, torch.float64), count, xi)[0]
                best = dist.min(0).values
                a = torch.from_numpy(got[:, i]).to(dev)
                if bool((a < 0).any()) or bool((a >= k).any()):
                    assign_gap = math.inf
                    break
                mine = dist.gather(0, a[None])[0]
                assign_gap = worst(assign_gap, float((mine - best).max() / best.mean()))
        self.detail = {"flip_share": flip}
        return [("init_diff", init_diff, lim["init_diff"]),
                ("center_gap", gap, lim["center_gap"]),
                ("assign_gap", assign_gap, lim["assign_gap"]),
                ("rows_wrong", float(self.wrong), 0.0)]
