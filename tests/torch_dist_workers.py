"""One rank of the port's data-parallel CPU tests (``test_torch_distributed``).

    python -m tests.torch_dist_workers RANK WORLD ADDRESS WORKDIR

Imports only the port (no JAX, no test module), joins a gloo group at
ADDRESS, runs every scenario on the inputs the test wrote into WORKDIR and
writes ``rank{RANK}.npz`` and ``rank{RANK}.json`` there:

* ``kmeans``: one warmup step with the given draws, then 3 post-warmup steps
  through K1's plain version, each rank on its half of the batch;
* ``clusters``: ``train_clusters`` (all-reduced) and ``assign_clusters``
  (per rank) over the feature pkls;
* ``batch_*`` / ``greedy_*``: the selectors with the candidates split over
  the ranks;
* ``extract``: equalized ``run_extraction`` over the clip shards, with its
  steps and its model forwards counted.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from acav100m_torch import runtime
from acav100m_torch.ops import kmeans, mi
from acav100m_torch.pipeline import clustering, feature_extraction


def run_kmeans(group, work: Path, out: dict) -> None:
    inp = np.load(work / "kmeans.npz")
    b_local = inp["rand"].shape[-1]
    rows = slice(group.rank * b_local, (group.rank + 1) * b_local)
    state = kmeans.init_state(list(inp["dims"]), int(inp["k"]),
                              centers=inp["centers"], device="cpu")
    for i, batch in enumerate(inp["batches"]):
        local = torch.from_numpy(np.ascontiguousarray(batch[:, rows]))
        rand = torch.from_numpy(inp["rand"]) if i == 0 else None
        state, _ = kmeans.train_step(state, local, float(inp["lr"]), rand=rand,
                                     initial_rounds=int(inp["initial_rounds"]), group=group)
        out[f"kmeans_counts_{i}"] = state.counts.numpy()
        out[f"kmeans_centers_{i}"] = state.centers.numpy()
        out[f"kmeans_count_{i}"] = np.asarray(state.count)
        out[f"kmeans_fallback_{i}"] = np.asarray(state.fallback)
    final = kmeans.assign_step(state, torch.from_numpy(np.ascontiguousarray(
        inp["batches"][-1][:, rows])))
    out["kmeans_assign"] = runtime.all_gather_cat(final, group, dim=1).numpy()


def run_clusters(group, work: Path, out: dict) -> None:
    cfg = clustering.get_config({
        "data.path": f"{work}/features/shard-{{000000..000001}}.pkl",
        "data.output.path": str(work / "clusters"), "data.batch_size": 8,
        "clustering.ncentroids": 4, "computation.shuffle_bufsize": 0,
        "computation.device": "cpu",
    })
    state, types, _ = clustering.train_clusters(cfg, group)
    out["clusters_centers"] = state.centers.numpy()
    out["clusters_counts"] = state.counts.numpy()
    out["clusters_count"] = np.asarray(state.count)
    saved = clustering.assign_clusters(cfg, state, types, group)
    out["clusters_assigned"] = [Path(p).name for p in saved]


def run_selectors(group, work: Path, out: dict) -> None:
    inp = np.load(work / "select.npz")
    for b in (16, 15):
        sel = mi.BatchGreedySelector(inp["batch_a"], list(map(tuple, inp["batch_pairs"])),
                                     ncentroids=8, batch_size=b, selection_size=4, seed=3,
                                     device="cpu", group=group)
        s, g, _, _ = sel.run_greedy(16, [0])
        out[f"batch_{b}"] = [s, g]
    for v in (60, 61):
        a = inp["greedy_a"][:v]
        combos = list(map(tuple, inp["greedy_pairs"]))
        for kind, scorer in (("mi", "mem"), ("ami", "full")):
            sel = mi.GreedySelector(a, combos, ncentroids=8, kind=kind, scorer=scorer,
                                    dtype="float64", group=group)
            s, g, _, _ = sel.run_greedy(36, list(range(16)))
            out[f"greedy_{v}_{kind}_{scorer}"] = [s, g, len(sel.active)]


def run_extract(group, work: Path, out: dict) -> None:
    from acav100m_torch.models import slowfast, vggish

    weights = torch.load(work / "weights.pt")
    models = OrderedDict([("layer_vggish", vggish.LayerVggish()),
                          ("layer_slowfast", slowfast.LayerSlowFast())])
    for name, model in models.items():
        model.load_state_dict(weights[name])
        model.eval()
    forwards = []
    models["layer_slowfast"].register_forward_hook(lambda *_: forwards.append(1))
    cfg = feature_extraction.get_config({
        "data.media.path": f"{work}/clips/shard-{{000000..000002}}.tar",
        "data.output.path": str(work / "features_extract"), "data.batch_size": 2,
        "data.media.num_frames": 4, "data.media.size": 16,
        "computation.equalize_length": True, "computation.device": "cpu",
    })
    log = io.StringIO()
    with contextlib.redirect_stdout(log):  # one "iter N" line a step (log_period 1)
        saved = feature_extraction.run_extraction(cfg, models=models, group=group)
    out["extract_steps"] = sum("] iter " in line for line in log.getvalue().splitlines())
    out["extract_forwards"] = len(forwards)
    out["extract_saved"] = [Path(p).name for p in saved]


def main(argv) -> None:
    rank, world, address, work = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    torch.set_num_threads(1)
    group = runtime.initialize_runtime(address, world, rank, device="cpu", timeout_s=120)
    arrays, meta = {}, {}
    try:
        for scenario in (run_kmeans, run_clusters, run_selectors, run_extract):
            out: dict = {}
            scenario(group, work, out)
            for key, val in out.items():
                (arrays if isinstance(val, np.ndarray) else meta)[key] = val
    finally:
        runtime.shutdown_runtime(group)
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    main(sys.argv[1:])
