"""The port's data parallelism on the CPU: two gloo ranks against the JAX
package's sharded functions on ``get_mesh(num_devices=2)``.

One spawn of two rank processes (``tests/torch_dist_workers.py``, which
imports only the port) runs every scenario on inputs written here and
writes its results; the spawn has a limit of its own and is killed past
it. Tolerances, with their reasons:

* k-means: counts, ``count`` and assignments equal; centers within 1e-5 of
  their max (the deltas are summed in another order than XLA's); the two
  ranks bit-identical (every rank applies the same all-reduced sums);
* ``train_clusters``: against one rank stepping on the same global rows
  (each step's two local batches concatenated): counts equal, centers
  within 1e-5 of their max (one sum over 16 rows against two of 8);
* selectors: picks equal; ``BatchGreedySelector`` gains within 1e-4
  relative (float32, as ``tests/test_sharded_selection.py``),
  ``GreedySelector`` gains within 1e-10 (float64, no pick a rounding tie
  from 16 folded start samples);
* extraction: taps within 1e-4 of the tap's max (as
  ``tests/test_torch_pipeline.py``), steps equal on both ranks, and the
  short rank's pad step runs no model.
"""

import json
import socket
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.data import tar_dataset as jtd
from acav100m_tpu.models import slowfast as jsf
from acav100m_tpu.models import vggish as jv
from acav100m_tpu.ops import kmeans as jk
from acav100m_tpu.ops import mi as jmi
from acav100m_tpu.ops.pairing import get_cluster_pairing
from acav100m_tpu.pipeline import feature_extraction as jfe
from acav100m_tpu.runtime import get_mesh
from acav100m_torch import cli as tcli
from acav100m_torch import runtime
from acav100m_torch.data import tar_dataset as ttd
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models import vggish as tv
from acav100m_torch.ops import kmeans as tk
from acav100m_torch.pipeline import clustering as tclu
from acav100m_torch.utils.io import dump_pickle, load_pickle, make_feature_row
from acav100m_torch.utils.shards import node_selection

from .test_mi import random_problem
from .torch_parity import random_variables

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
SPAWN_LIMIT_S = 180
KM = dict(dims=[16, 11, 6], k=4, b_local=16, initial_rounds=8, lr=0.05, steps=4)
FEATURE_DIMS = {"layer_vggish": [6, 5], "layer_slowfast": [8, 4]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kmeans_inputs(work: Path):
    rng = np.random.RandomState(0)
    dims, k, b = KM["dims"], KM["k"], KM["b_local"]
    m, d = len(dims), max(dims)
    protos = rng.randn(m, k, d).astype(np.float32) * 3
    batches = []
    for _ in range(KM["steps"]):
        lab = rng.randint(0, k, (m, WORLD * b))
        batch = protos[np.arange(m)[:, None], lab] + rng.randn(m, WORLD * b, d).astype(np.float32)
        for i, dd in enumerate(dims):
            batch[i, :, dd:] = 0.0
        batches.append(batch)
    centers = np.asarray(jk.init_state(jax.random.PRNGKey(0), dims, k).centers)
    key = jax.random.PRNGKey(1)
    # the JAX sharded step draws the same (M, K, B_local) uniforms on each shard
    rand = np.asarray(jax.random.uniform(key, (m, k, b), dtype=jnp.float32))
    np.savez(work / "kmeans.npz", batches=np.stack(batches), centers=centers, rand=rand,
             dims=np.array(dims), k=k, initial_rounds=KM["initial_rounds"], lr=KM["lr"])
    return batches, key


def _feature_shards(work: Path):
    rng = np.random.RandomState(2)
    for si in range(2):
        rows = []
        for ci in range(24):
            per_model = [{"model_key": key, "extractor_name": key, "dataset": "x",
                          "array": [rng.rand(d).astype(np.float32) + (ci % 3) for d in dims]}
                         for key, dims in FEATURE_DIMS.items()]
            rows.append(make_feature_row(f"clip_{si}_{ci:02d}.npz", f"shard-{si:06d}", 24,
                                         per_model, ["layer_vggish"]))
        dump_pickle(rows, work / "features" / f"shard-{si:06d}.pkl")


def _select_inputs(work: Path):
    batch_a, batch_pairs, _ = random_problem(np.random.RandomState(0), v=64)
    greedy_a = np.random.RandomState(0).randint(0, 8, (61, 4))
    greedy_pairs = get_cluster_pairing([(str(i), "x") for i in range(4)], "combination")
    np.savez(work / "select.npz", batch_a=batch_a, batch_pairs=np.array(batch_pairs),
             greedy_a=greedy_a, greedy_pairs=np.array(greedy_pairs))
    return batch_a, batch_pairs, greedy_a, greedy_pairs


def _extract_inputs(work: Path):
    tcli.write_fixtures(work / "clips", num_shards=3, clips_per_shard=2, size=16)
    sf = jax.eval_shape(
        lambda: jsf.LayerSlowFast().init(jax.random.PRNGKey(0), num_frames=4, size=16))
    vg = jax.eval_shape(lambda: jv.LayerVggish().init(jax.random.PRNGKey(0), 32000))
    variables = {"layer_vggish": random_variables(vg, seed=5),
                 "layer_slowfast": random_variables(sf, seed=6)}
    torch.save({"layer_vggish": tv.state_dict_from_flax(variables["layer_vggish"]),
                "layer_slowfast": tsf.state_dict_from_flax(variables["layer_slowfast"])},
               work / "weights.pt")
    return variables


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Inputs, then one 2-rank gloo spawn over all scenarios; returns the
    work directory, the inputs and each rank's results."""
    work = tmp_path_factory.mktemp("dist")
    inputs = {"kmeans": _kmeans_inputs(work), "select": _select_inputs(work),
              "extract": _extract_inputs(work)}
    _feature_shards(work)
    address = f"tcp://127.0.0.1:{_free_port()}"
    logs = [work / f"rank{rank}.log" for rank in range(WORLD)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_workers", str(rank), str(WORLD),
                 address, str(work)], cwd=REPO, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the 2-rank spawn ran past {SPAWN_LIMIT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-3000:]
    results = []
    for rank in range(WORLD):
        arrays = dict(np.load(work / f"rank{rank}.npz"))
        arrays.update(json.loads((work / f"rank{rank}.json").read_text()))
        results.append(arrays)
    return work, inputs, results


def test_kmeans_step_matches_jax_sharded(dist_run):
    _, inputs, (r0, r1) = dist_run
    batches, key = inputs["kmeans"]
    mesh = get_mesh(num_devices=WORLD)
    step = jk.make_sharded_train_step(mesh, initial_rounds=KM["initial_rounds"])
    state = jk.init_state(jax.random.PRNGKey(0), KM["dims"], KM["k"])
    warm = 0
    for i, batch in enumerate(batches):
        warm += int(state.count) < KM["initial_rounds"] * KM["k"]
        state, _ = step(state, jnp.asarray(batch), jnp.float32(KM["lr"]), key)
        np.testing.assert_array_equal(r0[f"kmeans_counts_{i}"], np.asarray(state.counts))
        assert int(r0[f"kmeans_count_{i}"]) == int(state.count) == (i + 1) * WORLD * KM["b_local"]
        assert int(r0[f"kmeans_fallback_{i}"]) == int(state.fallback)
        want = np.asarray(state.centers)
        np.testing.assert_allclose(r0[f"kmeans_centers_{i}"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        for name in ("counts", "centers", "count", "fallback"):
            assert np.array_equal(r0[f"kmeans_{name}_{i}"], r1[f"kmeans_{name}_{i}"])
    assert warm == 1  # then 3 steps through K1's plain version
    want = np.asarray(jk.assign_step(state, jnp.asarray(batches[-1])))
    np.testing.assert_array_equal(r0["kmeans_assign"], want)
    np.testing.assert_array_equal(r1["kmeans_assign"], want)


def test_train_clusters_two_ranks_match_one_rank_on_the_global_rows(dist_run):
    work, _, (r0, r1) = dist_run
    for name in ("centers", "counts", "count"):
        assert np.array_equal(r0[f"clusters_{name}"], r1[f"clusters_{name}"])
    caches = sorted((work / "clusters").glob("cache_epoch_*"))
    # 2 epochs over 2 ranks: one epoch, written once, by rank 0
    assert [p.name for p in caches] == ["cache_epoch_0_shard-{000000..000001}.pkl"]
    state, types, dims = tclu.load_centroids(caches[0])
    assert np.array_equal(state.centers.numpy(), r0["clusters_centers"])
    # one rank stepping on each step's two local batches concatenated, with
    # each rank's warmup draws side by side
    shards = sorted(str(p) for p in (work / "features").glob("shard-*.pkl"))
    streams = [[r for p in node_selection(shards, rank, WORLD, is_train=True)
                for r in load_pickle(p)] for rank in range(WORLD)]
    gens = [torch.Generator().manual_seed(1 + rank) for rank in range(WORLD)]
    one = tk.init_state(dims, 4, generator=torch.Generator().manual_seed(0))
    dmax = max(dims)
    for start in range(0, 48, 8):
        batch = np.concatenate([tclu.stack_batch(s[start:start + 8], types, dmax)
                                for s in streams], axis=1)
        rand = None
        if one.count < 10 * 4:
            rand = torch.cat([torch.rand((len(dims), 4, 8), generator=g) for g in gens], 2)
        one, _ = tk.train_step(one, torch.from_numpy(batch), tk.lr_schedule(0), rand=rand)
    assert one.count == int(r0["clusters_count"]) == 96
    np.testing.assert_array_equal(r0["clusters_counts"], one.counts.numpy())
    want = one.centers.numpy()
    np.testing.assert_allclose(r0["clusters_centers"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # phase B: each rank assigns its own shard
    assert r0["clusters_assigned"] == ["shard-000000.pkl"]
    assert r1["clusters_assigned"] == ["shard-000001.pkl"]


@pytest.mark.parametrize("b", [16, 15])
def test_batch_selector_matches_jax_sharded_and_unsharded(dist_run, b):
    _, inputs, (r0, r1) = dist_run
    a, pairs, _, _ = inputs["select"]
    kwargs = dict(ncentroids=8, batch_size=b, selection_size=4, seed=3)
    runs = [jmi.BatchGreedySelector(a, pairs, **kwargs).run_greedy(16, [0]),
            jmi.BatchGreedySelector(a, pairs, mesh=get_mesh(num_devices=WORLD),
                                    **kwargs).run_greedy(16, [0])]
    assert r0[f"batch_{b}"] == r1[f"batch_{b}"]
    s, g = r0[f"batch_{b}"]
    for js, jg, _, _ in runs:
        assert s == js
        np.testing.assert_allclose(g, jg, rtol=1e-4)


@pytest.mark.parametrize("v", [60, 61])
@pytest.mark.parametrize("kind,scorer", [("mi", "mem"), ("ami", "full")])
def test_greedy_selector_matches_jax_sharded(dist_run, v, kind, scorer):
    _, inputs, (r0, r1) = dist_run
    _, _, a, combos = inputs["select"]
    key = f"greedy_{v}_{kind}_{scorer}"
    assert r0[key] == r1[key]
    s, g, rows = r0[key]
    assert rows == v + v % WORLD  # 61 pads one row
    js = jmi.GreedySelector(a[:v], combos, ncentroids=8, kind=kind, scorer=scorer,
                            dtype="float64", mesh=get_mesh(num_devices=WORLD))
    jsel, jgain, _, _ = js.run_greedy(36, list(range(16)))
    assert s == jsel and len(s) == 35
    assert all(i < v for i in s)  # no padded row is ever picked
    np.testing.assert_allclose(g, jgain, rtol=0, atol=1e-10)


def test_padding_helpers_match_jax():
    real = {"filename": ["a", "b"], "shard_name": ["s", "s"], "shard_size": [2, 2],
            "batch_mask": np.array([True, True]),
            "frames": np.ones((2, 4, 8, 8, 3), np.uint8),
            "audio": np.ones((2, 16), np.float32),
            "valid_samples": np.array([16, 9], np.int32)}

    def same(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for key in w:
                if isinstance(w[key], np.ndarray):
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(g[key], w[key])
                else:
                    assert g[key] == w[key]

    same(list(ttd.pad_to_length(iter([real]), 3)), list(jtd.pad_to_length(iter([real]), 3)))
    tmpl = (ttd.empty_batch(2, num_frames=4, size=8, audio_len=16),
            jtd.empty_batch(2, num_frames=4, size=8, audio_len=16))
    same([tmpl[0]], [tmpl[1]])
    same([ttd.empty_batch_like(real)], [jtd.empty_batch_like(real)])
    same(list(ttd.pad_to_length(iter([]), 2, tmpl[0])),
         list(jtd.pad_to_length(iter([]), 2, tmpl[1])))
    with pytest.raises(ValueError):
        list(ttd.pad_to_length(iter([]), 1))


def test_equalized_extraction_steps_in_lockstep_and_matches_jax(dist_run):
    work, inputs, (r0, r1) = dist_run
    variables = inputs["extract"]
    # rank 0 holds shards 0 and 2 (2 batches), rank 1 shard 1 (1 batch and 1
    # pad); the pad is a step that runs no model
    assert r0["extract_steps"] == r1["extract_steps"] == 2
    assert (r0["extract_forwards"], r1["extract_forwards"]) == (2, 1)
    assert r0["extract_saved"] == ["shard-000000.pkl", "shard-000002.pkl"]
    assert r1["extract_saved"] == ["shard-000001.pkl"]
    jmodels = OrderedDict([("layer_vggish", jv.LayerVggish()),
                           ("layer_slowfast", jsf.LayerSlowFast())])
    for index in range(WORLD):
        jfe.run_extraction(jfe.get_config({
            "data.media.path": f"{work}/clips/shard-{{000000..000002}}.tar",
            "data.output.path": str(work / "jax_features"), "data.batch_size": 2,
            "data.media.num_frames": 4, "data.media.size": 16,
            "computation.index": index, "computation.total": WORLD,
            "computation.equalize_length": True}), models=jmodels, params=variables)
    for name in ("shard-000000.pkl", "shard-000001.pkl", "shard-000002.pkl"):
        jrows = load_pickle(work / "jax_features" / name)
        trows = load_pickle(work / "features_extract" / name)
        assert [r["filename"] for r in trows] == [r["filename"] for r in jrows]
        for jr, tr in zip(jrows, trows):
            for side in ("audio_features", "video_features"):
                for layer, want in jr[side][0]["array"].items():
                    got = tr[side][0]["array"][layer]
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=1e-4 * np.abs(want).max())


def test_runtime_single_process_and_placement():
    group = runtime.initialize_runtime(num_processes=1, device="cpu")
    assert (group.rank, group.world_size, group.distributed) == (0, 1, False)
    t = torch.arange(4.0)
    assert runtime.all_reduce_sum(t, group) is t
    assert runtime.all_gather_cat(t, group) is t
    runtime.barrier(group)
    two = runtime.Group(1, 2, torch.device("cpu"), "gloo")
    assert runtime.placement(0, 1, two) == (1, 2)
    assert runtime.placement(1, 2, two) == (1, 2)
    assert runtime.placement(3, 5, None) == (3, 5)
    with pytest.raises(ValueError):
        runtime.placement(0, 2, two)
    with pytest.raises(ValueError):  # NCCL wants a CUDA device
        runtime.initialize_runtime(num_processes=1, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # never a silent move to the CPU
            runtime.initialize_runtime(num_processes=1)
