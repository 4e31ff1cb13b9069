"""Stage 6, subset selection: ``acav100m_torch.pipeline.subset_selection.run``.

Traffic (kind ``select``): ``shards`` assignment pkls of ``rows_per_shard``
clips in stage 5's schema (ten clusterings, the configuration's K), and
each shard's json of ids and segments. Assignments come from
``classes`` latent classes through a fixed random map per clustering: a
``corresponding_share`` of the clips take all ten from one class, the
rest take the audio clusterings from one class and the video ones from
another; each assignment is redrawn uniformly with probability
``redraw_p``. Made from the seed and written once at set-up. A call
selects from the whole pool into a fresh ``output.csv``. Work: the pool's
clips, for a call whose csv came out whole.

The check. The stage's entry returns only the sorted set of picks; the
harness keeps what ``BatchGreedySelector.run_greedy`` returned (the picks
in order and their scores) by wrapping it. The reference
(``reference/batch_mi.py``, float64) replays one call drawn from the seed
from the same seed, following the program's picks: ``pick_gap`` is the
largest amount by which a pick's score lies below the reference's k-th
best of its batch, ``gain_err`` the largest error of a pick's reported
score, ``foreign_picks`` the picks not in their iteration's batch, and
``csv_wrong`` the rows of every call's ``output.csv`` that differ from
the picks' metadata (exact).
"""

from __future__ import annotations

import csv
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import dotted
from benchmark.reference import batch_mi

TAPS = (("layer_slowfast", "video_assignments"), ("layer_vggish", "audio_assignments"))


class Stage:
    def __init__(self, ctx):
        self.ctx = ctx
        self.c = ctx.config["select"]
        self.t = ctx.traffic
        self.k = ctx.config["cluster"]["ncentroids"]
        models = ctx.config["models"]
        self.types = sorted((key, f"layer_{i}") for key, _ in TAPS
                            for i in range(len(models[key]["tap_dims"])))
        self.calls: List[Path] = []
        self.returned: List[Tuple[List[int], List[float]]] = []
        self.wrong = 0

    def setup(self) -> None:
        self.make_traffic()
        from acav100m_torch.ops import mi

        self._mi = mi
        self._run_greedy = mi.BatchGreedySelector.run_greedy
        stage = self

        def recording_run_greedy(selector, subset_size, start_indices=()):
            out = stage._run_greedy(selector, subset_size, start_indices)
            stage.returned.append((list(out[0]), list(out[1])))
            return out

        mi.BatchGreedySelector.run_greedy = recording_run_greedy
        # warm-up: one short call (two shards) at the cell's shapes
        self._select(self.spec.replace(f"{self.t['shards'] - 1:06d}}}", "000001}"),
                     self.ctx.work / "warmup.csv")
        self.returned.clear()

    def make_traffic(self) -> None:
        """The assignments and the pkls and jsons (under the work dir)."""
        ctx, t = self.ctx, self.t
        rng = np.random.default_rng(ctx.subseed("assignments"))
        n, m = t["shards"] * t["rows_per_shard"], len(self.types)
        maps = np.stack([rng.permutation(self.k) for _ in range(m)])  # class -> cluster
        audio = np.array([key == "layer_vggish" for key, _ in self.types])
        cls_a = rng.integers(0, t["classes"], n)
        cls_v = np.where(rng.random(n) < t["corresponding_share"], cls_a,
                         rng.integers(0, t["classes"], n))
        cls = np.where(audio[None, :], cls_a[:, None], cls_v[:, None])  # (n, m)
        a = maps[np.arange(m)[None, :], cls % self.k]
        redraw = rng.random((n, m)) < t["redraw_p"]
        self.assignments = np.where(redraw, rng.integers(0, self.k, (n, m)), a)

        data, meta = ctx.work / "assignments", ctx.work / "meta"
        data.mkdir()
        meta.mkdir()
        import pickle

        self.rows = []  # (shard, filename, id, segment) by pool index
        for s in range(t["shards"]):
            shard, rows, metas = f"shard-{s:06d}", [], []
            for j in range(t["rows_per_shard"]):
                g = s * t["rows_per_shard"] + j
                fname = f"v{g:06d}.mp4"
                row = {"filename": fname, "shard_name": shard,
                       "shard_size": t["rows_per_shard"],
                       "video_assignments": [], "audio_assignments": []}
                for key, side in TAPS:
                    row[side].append({"model_key": key, "array": {
                        layer: int(self.assignments[g, i])
                        for i, (k2, layer) in enumerate(self.types) if k2 == key}})
                rows.append(row)
                seg = [float(j % 7), float(j % 7) + 10.0]
                metas.append({"filename": fname, "id": f"yt{g:06d}", "segment": seg})
                self.rows.append((shard, fname, f"yt{g:06d}", seg))
            with open(data / f"{shard}.pkl", "wb") as f:
                pickle.dump(rows, f)
            (meta / f"{shard}.json").write_text(json.dumps(metas))
        self.spec = str(data / f"shard-{{000000..{t['shards'] - 1:06d}}}.pkl")
        self.meta = meta

    def _select(self, spec: str, out: Path) -> None:
        from acav100m_torch.pipeline import subset_selection

        c = self.c
        cfg = subset_selection.get_config(dotted({
            "data": {"path": spec, "output": {"path": str(out)},
                     "meta": {"path": str(self.meta)}},
            "computation": {"random_seed": self.ctx.subseed("program"), "dtype": c["dtype"],
                            "device": self.ctx.device.type},
            "subset": {"ratio": c["ratio"]},
            "clustering": {"pairing": c["pairing"]},
            "batch": {"batch_size": c["batch_size"], "selection_size": c["selection_size"],
                      "keep_unselected": c["keep_unselected"]},
            "measure_name": c["measure_name"],
        }))
        subset_selection.run(cfg)
        if self.ctx.cuda:
            torch.cuda.synchronize()

    def call(self, i: int) -> None:
        out = self.ctx.work / "out" / f"call{i:04d}" / "output.csv"
        self._select(self.spec, out)
        self.calls.append(out)

    def subset(self) -> int:
        return round(self.c["ratio"] * len(self.rows))

    def count_units(self, calls: int) -> Tuple[int, int]:
        units = 0
        for out, (picks, _) in zip(self.calls, self.returned):
            want = [self.rows[p] for p in sorted(set(picks))[:self.subset()]]
            got = []
            if out.is_file():
                with open(out) as f:
                    got = [(r[0], r[1], r[2], json.loads(r[3])) for r in csv.reader(f)]
            wrong = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
            self.wrong += wrong
            units += len(self.rows) if wrong == 0 else 0
        self.wrong += abs(len(self.calls) - len(self.returned))
        return units, len(self.calls) * len(self.rows)

    def layer_info(self, calls: int) -> Dict:
        return {"picks": calls * self.subset()}

    def spans(self):
        """Program layers that the traced run names idle gaps by."""
        from acav100m_torch.ops import mi
        from acav100m_torch.pipeline import subset_selection as ss

        return [(ss, "load_partitions_data", "span.load_partitions"),
                (ss, "format_rows", "span.format_rows"),
                (ss, "save_output_csv", "span.save_output_csv"),
                (mi.BatchGreedySelector, "_step", "span.score_and_fold"),
                (mi.BatchGreedySelector, "shuffle_candidates", "span.shuffle_pool")]

    def release(self) -> None:
        if self.ctx.cuda:
            torch.cuda.empty_cache()

    def close(self) -> None:
        if getattr(self, "_run_greedy", None) is not None:
            self._mi.BatchGreedySelector.run_greedy = self._run_greedy

    def check(self, calls: int) -> List[Tuple[str, float, float]]:
        lim, c = self.ctx.limits, self.c
        from itertools import combinations

        res = {"pick_gap": math.inf, "gain_err": math.inf, "foreign": math.inf}
        if self.returned:
            picks, gains = self.returned[self.ctx.subseed("check") % len(self.returned)]
            v = len(self.rows)
            res = batch_mi.replay(self.assignments, list(combinations(range(len(self.types)), 2)),
                                  int(self.assignments.max()) + 1, self.subset(),
                                  min(c["batch_size"], v - 1), c["selection_size"],
                                  self.ctx.subseed("program"), picks, gains)
            if len(picks) < self.subset():
                res["foreign"] += self.subset() - len(picks)
        return [("pick_gap", res["pick_gap"], lim["pick_gap"]),
                ("gain_err", res["gain_err"], lim["gain_err"]),
                ("foreign_picks", res["foreign"], 0.0),
                ("csv_wrong", float(self.wrong), 0.0)]
