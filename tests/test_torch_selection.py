"""Stage 6 driver: ``select`` of the port against the JAX package's on the
same JAX-written assignment pkls, run manifest and shard jsons gives a
byte-identical ``output.csv``, in float64, float32 and bfloat16; chunk mode
gives byte-identical per-chunk cache csvs (the pid in their names
normalised), ``output.csv`` and ``reduce`` merges.

The assignments come from a seeded latent-class model (each clip a class,
each of the ten clusterings a noisy function of it), like real stage-5
output. A cache that holds only the start singleton makes many distinct
candidates tie mathematically, and rounding then picks among them in each
framework; the fixture's seed is one whose decisions both frameworks make
alike (see tests/test_torch_mi.py), in bfloat16 too, where the cache and
the scores round per op and many scores tie.

The whole-pool measures never fold the start singleton, so their first
pick is a tie of every candidate. With the incremental scorer (``mem_mi``)
the arithmetic ties too and both frameworks take the first index; with the
full-table scorers (``mi``, ``ami``, ``nmi``) each framework's summation
order decides every tie, so those runs are pinned by replaying the port's
picks through the JAX package's scorer: each pick must be a maximum within
1e-12 in float64 (ROADMAP.md section C)."""

import json
import time

import numpy as np
import pytest
import torch

from acav100m_tpu import cli as jcli
from acav100m_tpu.ops import mi as jmi
from acav100m_tpu.pipeline import subset_selection as jss
from acav100m_tpu.utils.io import dump_pickle
from acav100m_tpu.utils.manifests import write_run_manifest
from acav100m_torch import cli as tcli
from acav100m_torch.ops import mi as tmi
from acav100m_torch.pipeline import subset_selection as tss

torch.set_num_threads(1)

SHARDS, ROWS, C = 2, 40, 8
SPEC = "shard-{000000..000001}"
SEED = 0
MEASURE_SEED = 3  # mem_mi's picks hang on no rounding tie, in float32 too


def write_assignments(root, seed=SEED):
    rng = np.random.RandomState(seed)
    protos = rng.randint(0, C, (6, 10))
    paths = []
    for si in range(SHARDS):
        rows, meta = [], []
        for ci in range(ROWS):
            lab = protos[rng.randint(6)]
            noisy = np.where(rng.rand(10) < 0.35, rng.randint(0, C, 10), lab)
            fname = f"clip_{si:03d}_{ci:03d}.npz"
            rows.append({
                "filename": fname, "shard_name": f"shard-{si:06d}", "shard_size": ROWS,
                "audio_assignments": [{"model_key": "layer_vggish", "array": {
                    f"layer_{i}": int(noisy[i]) for i in range(5)}}],
                "video_assignments": [{"model_key": "layer_slowfast", "array": {
                    f"layer_{i}": int(noisy[5 + i]) for i in range(5)}}],
            })
            if ci % 7 != 3:  # some clips have no metadata: id -1
                meta.append({"filename": fname, "id": f"v{si}{ci:03d}",
                             "segment": [float(ci), float(ci) + 10.0]})
        paths.append(dump_pickle(rows, root / "clusters" / f"shard-{si:06d}.pkl"))
        (root / "meta").mkdir(exist_ok=True)
        (root / "meta" / f"shard-{si:06d}.json").write_text(json.dumps(meta))
    write_run_manifest(root / "clusters", paths)


@pytest.fixture(scope="module")
def assignments(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage6")
    write_assignments(root)
    return root


@pytest.fixture(scope="module")
def measure_assignments(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage6_measures")
    write_assignments(root, MEASURE_SEED)
    return root


def _run_both(root, tag, over):
    """``run`` of both packages on ``root``'s pkls -> {name: (path, count)}."""
    outs = {}
    for name, mod, extra in (("jax", jss, {}), ("torch", tss, {"computation.device": "cpu"})):
        out = root / tag / name / "output.csv"
        cfg = mod.get_config({"data.path": f"{root}/clusters/{SPEC}.pkl",
                              "data.output.path": str(out),
                              "data.meta.path": str(root / "meta"), **over, **extra})
        outs[name] = mod.run(cfg)
    return outs


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_output_csv_byte_identical(assignments, dtype):
    outs = {}
    for name, mod, extra in (("jax", jss, {}), ("torch", tss, {"computation.device": "cpu"})):
        out = assignments / f"{name}_{dtype}.csv"
        cfg = mod.get_config({"data.path": f"{assignments}/clusters/{SPEC}.pkl",
                              "data.output.path": str(out),
                              "data.meta.path": str(assignments / "meta"),
                              "computation.dtype": dtype, **extra})
        path, count = mod.run(cfg)
        assert count == round(0.2 * SHARDS * ROWS)
        outs[name] = path.read_bytes()
    assert outs["torch"] == outs["jax"]
    assert b",-1," in outs["torch"]  # the missing-meta join is exercised


def test_format_rows_and_metas_match_jax(assignments):
    from acav100m_tpu.utils.io import load_pickle

    rows = load_pickle(assignments / "clusters" / "shard-000000.pkl")
    ja, js, jf, jt = jss.format_rows(rows)
    ta, ts, tf, tt = tss.format_rows(rows)
    np.testing.assert_array_equal(ta, ja)
    assert (ts, tf, tt) == (js, jf, jt)
    paths = tss.expand_shard_paths(f"{assignments}/clusters/{SPEC}.pkl")
    assert paths == jss.expand_shard_paths(f"{assignments}/clusters/{SPEC}.pkl")
    assert tss.load_metas(assignments / "meta", paths) == jss.load_metas(
        assignments / "meta", paths)
    assert tss.load_partitions_data(paths) == jss.load_partitions_data(paths)


def test_unknown_measure_raises(assignments):
    for mod, extra in ((jss, {}), (tss, {"computation.device": "cpu"})):
        cfg = mod.get_config({"data.path": f"{assignments}/clusters/{SPEC}.pkl",
                              "data.output.path": str(assignments / "unknown.csv"),
                              "measure_name": "nope", **extra})
        with pytest.raises(ValueError, match="unknown measure"):
            mod.run(cfg)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mem_mi_output_csv_byte_identical(measure_assignments, dtype):
    outs = _run_both(measure_assignments, f"mem_mi_{dtype}",
                     {"measure_name": "mem_mi", "computation.dtype": dtype})
    # the pool greedy returns the start singleton and loops to subset - 1
    assert outs["torch"][1] == outs["jax"][1] == round(0.2 * SHARDS * ROWS) - 1
    assert outs["torch"][0].read_bytes() == outs["jax"][0].read_bytes()


@pytest.mark.parametrize("measure", ["mi", "ami", "nmi"])
def test_full_measure_select_picks_maxima(measure_assignments, measure):
    root = measure_assignments
    outs = _run_both(root, measure, {"measure_name": measure, "computation.dtype": "float64"})
    assert outs["torch"][1] == outs["jax"][1] == round(0.2 * SHARDS * ROWS) - 1
    # the port's selection, replayed through the JAX package's scorer
    rows = tss.load_partitions_data(tss.expand_shard_paths(f"{root}/clusters/{SPEC}.pkl"))
    (rows,) = rows.values()
    a, _, filenames, types = tss.format_rows(rows)
    combos = tss.get_cluster_pairing(types, "combination")
    rng = np.random.RandomState(0)
    candidates = np.arange(len(a))
    rng.shuffle(candidates)
    start, subset = int(candidates[0]), round(0.2 * len(a))
    ncentroids = int(a.max()) + 1
    ts = tmi.GreedySelector(a, combos, ncentroids, kind=measure, scorer="full",
                            dtype="float64", device="cpu")
    picks, _, _, _ = ts.run_greedy(subset, [start], fold_start=False)
    js = jmi.GreedySelector(a, combos, ncentroids, kind=measure, scorer="full",
                            dtype="float64")
    js.active[start] = False
    for pick in picks[1:]:
        scores = np.where(js.active, js.scores(), -np.inf)
        assert js.active[pick]
        assert scores[pick] >= scores.max() - 1e-12 * (1 + abs(scores.max()))
        js.add_samples([pick])
    got = [line.split(",")[1] for line in outs["torch"][0].read_text().splitlines()]
    assert got == [filenames[i] for i in sorted(picks)]


def _cache_csvs(out_csv):
    """{name with the run's pid removed: bytes} of the chunk caches."""
    caches = {}
    for p in sorted((out_csv.parent / "caches").glob("cache_*")):
        parts = p.name.split("_")
        caches["_".join([parts[0]] + parts[2:])] = p.read_bytes()
    return caches


def _chunk_cfg(mod, root, out, size, extra=()):
    over = {"data.path": f"{root}/clusters/{SPEC}.pkl", "data.output.path": str(out),
            "data.meta.path": str(root / "meta"), "chunk_size": 1,
            "computation.dtype": "float64", **dict(extra)}
    if size is not None:
        over["subset.size"] = size
    return mod.get_config(over)


@pytest.mark.parametrize("size", [None, 9])
def test_chunk_mode_byte_identical(assignments, size):
    outs = {}
    for name, mod, extra in (("jax", jss, ()), ("torch", tss, {"computation.device": "cpu"})):
        out = assignments / f"chunks_{size}" / name / "output.csv"
        path, count = mod.run(_chunk_cfg(mod, assignments, out, size, extra))
        # per chunk: ceil(9 / 2) = 5 rows, or round(0.2 * 40) = 8
        assert count == SHARDS * (5 if size else 8)
        outs[name] = (path.read_bytes(), _cache_csvs(out))
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"][1]) == SHARDS
    # reduce of the port's caches, through both command lines
    caches = sorted(str(p) for p in (assignments / f"chunks_{size}" / "torch" / "caches").iterdir())
    for name, cli in (("jax", jcli), ("torch", tcli)):
        merged = assignments / f"chunks_{size}" / f"reduced_{name}.csv"
        cli.main(["reduce", str(merged), *caches])
        assert merged.read_bytes() == outs["torch"][0]


def test_chunk_mode_prefetch_and_skip(assignments, monkeypatch):
    out = assignments / "prefetch" / "output.csv"
    cfg = _chunk_cfg(tss, assignments, out, 4, {"computation.device": "cpu"})
    select = tss.run_greedy_partition

    def slow_select(*args, **kwargs):  # a selection long enough to overlap
        time.sleep(0.3)
        return select(*args, **kwargs)

    monkeypatch.setattr(tss, "run_greedy_partition", slow_select)
    trace = []
    _, count = tss.run_chunks(cfg, _trace=trace)
    assert count == 4
    events = {(e, i): t for e, i, t in trace}
    # chunk 1's load is submitted before chunk 0's selection ends, and chunk
    # 0 selects only after its own load completed
    assert events[("load_start", 1)] <= events[("select_done", 0)]
    assert events[("load_done", 0)] <= events[("select_start", 0)]
    # a second run finds both cache csvs and selects nothing again
    trace = []
    _, count = tss.run_chunks(cfg, _trace=trace)
    assert trace == [] and count == 4
