"""The port's correspondence retrieval (``acav100m_torch.retrieval``)
against the JAX package's on the same seeded inputs: ``sgd_kmeans`` with the
JAX draws replayed, ``run_experiment`` across frontends and optimizers, the
sharded experiments, the option grid, the process pool and the CLI verb."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from acav100m_tpu.ops import kmeans as jk
from acav100m_tpu.retrieval import clustering as jc
from acav100m_tpu.retrieval import runner as jr
from acav100m_tpu.retrieval import sharded as jsh
from acav100m_torch.ops import kmeans as tk
from acav100m_torch.retrieval import clustering as tc
from acav100m_torch.retrieval import runner as tr
from acav100m_torch.retrieval import sharded as tsh

torch.set_num_threads(1)


def jax_sgd_draws(seed, v, d, k, epochs=20, batch_size=64, initial_rounds=10):
    """The JAX ``sgd_kmeans``'s random draws: its initial centers (K, D) and
    each warmup step's (1, K, rows) assignment draws, from the same keys and
    in the same order as its loop."""
    centers = np.asarray(jk.init_state(jax.random.PRNGKey(seed), [d], k, d).centers[0])
    key = jax.random.PRNGKey(seed + 1)
    draws, seen = [], 0
    for _ in range(epochs):
        for i in range(0, v, batch_size):
            if seen >= initial_rounds * k:
                return centers, draws
            key, sub = jax.random.split(key)
            rows = min(batch_size, v - i)
            draws.append(np.asarray(jax.random.uniform(sub, (1, k, rows))))
            seen += rows
    return centers, draws


def replayed_sgd(features, ncentroids, seed=0, device=None, **kw):
    """The port's ``sgd_kmeans`` on the JAX package's draws for ``seed``."""
    v, d = features.shape
    centers, draws = jax_sgd_draws(seed, v, d, ncentroids)
    return tc.sgd_kmeans(features, ncentroids, seed=seed, device=device,
                         init_centers=centers, warmup_draws=draws, **kw)


def blobs(seed, v, d, k=10):
    rng = np.random.RandomState(seed)
    means = rng.randn(k, d) * 2.0
    x = means[rng.randint(0, k, v)] + 0.3 * rng.randn(v, d)
    return tc.whiten(x.astype(np.float32))


@pytest.mark.parametrize("d", [16, 6])
def test_sgd_kmeans_matches_jax(d, monkeypatch):
    """Assignments equal and centers within 1e-5 after 20 epochs of 5 steps
    (4 of 64 rows, a tail of 44); D=6 takes the padded route (K1 takes
    widths in multiples of 4)."""
    v, k, seed = 300, 10, 3
    x = blobs(seed, v, d)
    jax_steps, port_steps = [], []
    split = jax.random.split

    def counted_split(key, *a):  # the JAX loop splits its key once a step
        jax_steps.append(1)
        return split(key, *a)

    monkeypatch.setattr(jax.random, "split", counted_split)
    want = jc.sgd_kmeans(x, k, seed=seed)
    monkeypatch.setattr(jax.random, "split", split)
    train_step = tk.train_step

    def counted(state, batch, *a, **kw):
        port_steps.append(batch.shape)
        return train_step(state, batch, *a, **kw)

    monkeypatch.setattr(tk, "train_step", counted)
    got = replayed_sgd(x, k, seed=seed, device="cpu")
    assert len(port_steps) == len(jax_steps) == 20 * 5
    assert port_steps[4] == (1, 44, -(-d // 4) * 4)
    assert got.assignments.dtype == np.int32
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert got.centers.shape == want.centers.shape == (k, d)
    np.testing.assert_allclose(got.centers, want.centers, rtol=1e-5, atol=1e-5)
    # the K1 route (its plain version on the CPU) against the plain steps
    monkeypatch.setattr(tk, "train_step",
                        lambda *a, **kw: train_step(*a, **kw, use_pallas=False))
    plain = replayed_sgd(x, k, seed=seed, device="cpu")
    np.testing.assert_array_equal(plain.assignments, got.assignments)
    np.testing.assert_allclose(plain.centers, got.centers, rtol=1e-6, atol=1e-6)


def test_sgd_kmeans_tells_k1_the_real_width(monkeypatch):
    from acav100m_torch.ops import kmeans_kernel

    seen = []
    ref = kmeans_kernel.fused_assign_update_ref

    def spy(centers, counts, batch, threshold):
        seen.append(tuple(batch.shape))
        assert float(batch[..., 6:].abs().max()) == 0.0
        assert float(centers[..., 6:].abs().max()) == 0.0
        return ref(centers, counts, batch, threshold)

    monkeypatch.setattr(kmeans_kernel, "fused_assign_update_ref", spy)
    dims = []
    fused = tk.fused_assign_update

    def told(*a, **kw):
        dims.append(kw["dims"])
        return fused(*a, **kw)

    monkeypatch.setattr(tk, "fused_assign_update", told)
    tc.sgd_kmeans(blobs(0, 100, 6), 4, seed=0, epochs=2, device="cpu")
    # warmup is 40 samples: the first step of 64 rows assigns at random
    assert seen == [(1, 36, 8), (1, 64, 8), (1, 36, 8)]
    assert dims == [(6,)] * 3


def test_sgd_kmeans_is_seeded():
    x = blobs(1, 120, 16)
    a = tc.sgd_kmeans(x, 5, seed=4, device="cpu")
    b = tc.sgd_kmeans(x, 5, seed=4, device="cpu")
    np.testing.assert_array_equal(a.assignments, b.assignments)
    np.testing.assert_array_equal(a.centers, b.centers)


def test_sgd_kmeans_leaves_the_digits_resnet_taps_in_one_cluster():
    """The digits stand-in's ResNet-50 taps (``--dataset resnet_pairs`` at its
    default 6 classes x 12, all four taps of the original view), whitened as
    ``cluster_views`` does: with the JAX draws replayed, the port's
    ``sgd_kmeans`` puts every row in one cluster, as the JAX package's does.
    Assignments equal, centers within 1e-4."""
    from acav100m_torch.retrieval import features as tf

    images, labels = tf.synthetic_digits(nclasses=6, per_class=12)
    views = tf.resnet_pair_views(images, labels, layers=(0, 1, 2, 3), device="cpu")
    for i, d in enumerate((256, 512, 1024, 2048)):
        view = views[f"orig-layer_{i}"]
        x = tc.whiten(np.stack([view[key]["data"] for key in sorted(view)]))
        assert x.shape == (72, d)
        want = jc.sgd_kmeans(x, 6, seed=i)
        got = replayed_sgd(x, 6, seed=i, device="cpu")
        np.testing.assert_array_equal(got.assignments, want.assignments)
        assert np.unique(got.assignments).size == 1
        np.testing.assert_allclose(got.centers, want.centers, rtol=1e-4, atol=1e-4)


def test_sgd_kmeans_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.sgd_kmeans(blobs(0, 20, 4), 2)


@pytest.mark.parametrize("method", ["scipy", "sklearn", "pca"])
def test_host_frontends_are_the_jax_packages(method):
    feats = {"a-l0": blobs(2, 90, 8, k=4), "b-l0": blobs(3, 90, 5, k=4)}
    got = tc.cluster_views(feats, 4, method=method, seed=1, device="cpu")
    want = jc.cluster_views(feats, 4, method=method, seed=1)
    for view in want:
        np.testing.assert_array_equal(got[view].assignments, want[view].assignments)
        np.testing.assert_array_equal(got[view].centers, want[view].centers)
    np.testing.assert_array_equal(tc.assignments_matrix(got), jc.assignments_matrix(want))


@pytest.fixture
def replay_sgd(monkeypatch):
    """Routes the port's ``sgd`` frontend through the JAX draws."""
    monkeypatch.setitem(tc._FRONTENDS, "sgd", replayed_sgd)


ONE = dict(nclasses=6, per_class=20, num_layers=1, noise=0.3)
TWO = dict(nclasses=6, per_class=20, num_layers=2, noise=0.3)
SMALL = dict(nclasses=4, per_class=8, num_layers=1, noise=0.3)

# (frontend, optimizer, measure, views, seed): every frontend and every
# optimizer. Greedy MI ties in exact arithmetic between candidates in
# different cells, and each framework's rounding then picks (ROADMAP.md, how
# parity is checked): with one cluster pair (ONE, SMALL) and these seeds,
# every step's maximum either stands 1e-3 or more above all other candidates
# or is shared only by candidates whose scores both packages compute to the
# same bits, so the first index wins in both. efficient_batch's picks at
# its seeds are the same in float32 and float64 in both packages. greedy
# and celf score with the same numpy oracle in both packages; pca_rank
# uses no clustering.
EXPERIMENTS = [
    ("sgd", "efficient_greedy", "mi", dict(SMALL, per_class=10), 0),
    ("scipy", "efficient_greedy", "mi", ONE, 2),
    ("sklearn", "efficient_greedy", "mi", ONE, 1),
    ("pca", "efficient_greedy", "mi", ONE, 3),
    ("sgd", "efficient_batch", "mi", TWO, 4),
    ("sklearn", "efficient_batch", "mi", TWO, 5),
    ("sgd", "pca_rank", "pca", ONE, 6),
    ("scipy", "pca_rank", "pca_cs", TWO, 7),
    ("sklearn", "greedy", "mi", SMALL, 7),
    ("sgd", "greedy", "mi", SMALL, 2),
    ("sgd", "celf", "mi", SMALL, 8),
    ("scipy", "celf", "mi", SMALL, 9),
]


@pytest.mark.parametrize("method,optimizer,measure,views,seed", EXPERIMENTS)
def test_run_experiment_matches_jax(method, optimizer, measure, views, seed, replay_sgd):
    kw = dict(ncentroids=views["nclasses"], clustering_method=method,
              optimizer=optimizer, measure=measure, seed=seed)
    views = tr.gaussian_pair_views(seed=seed, **views)
    got = tr.run_experiment(views=views, device="cpu", **kw)
    want = jr.run_experiment(views=views, **kw)
    for key in ("selection", "true_ids", "precision", "recall", "f1", "subset_size",
                "dataset_size", "prefix_scores", "config"):
        assert got[key] == want[key], key


def test_run_experiment_writes_the_result_pkl(tmp_path, replay_sgd):
    from acav100m_torch.utils.io import load_pickle

    views = tr.gaussian_pair_views(seed=0, **SMALL)
    res = tr.run_experiment(views=views, ncentroids=4, seed=0, device="cpu",
                            out_path=tmp_path / "r.pkl")
    assert load_pickle(tmp_path / "r.pkl") == res


def test_contrastive_f1_near_jax():
    """Probe inits differ by design (``torch.Generator`` against
    ``jax.random``): F1 within 0.05."""
    views = tr.gaussian_pair_views(nclasses=6, per_class=20, num_layers=1,
                                   noise=0.2, seed=5)
    kw = dict(ncentroids=6, clustering_method="sklearn", optimizer="contrastive", seed=0)
    got = tr.run_experiment(views=views, device="cpu", **kw)
    want = jr.run_experiment(views=views, **kw)
    assert got["true_ids"] == want["true_ids"]
    assert abs(got["f1"] - want["f1"]) <= 0.05, (got["f1"], want["f1"])
    assert got["f1"] >= 0.9


def test_gaussian_and_image_views_are_the_jax_packages():
    a, b = tr.gaussian_pair_views(seed=3), jr.gaussian_pair_views(seed=3)
    assert sorted(a) == sorted(b)
    for view in a:
        for vid in a[view]:
            np.testing.assert_array_equal(a[view][vid]["data"], b[view][vid]["data"])
            assert a[view][vid]["label"] == b[view][vid]["label"]
    rng = np.random.RandomState(0)
    images, labels = rng.rand(12, 6, 6), rng.randint(0, 3, 12)
    for transform in ("rotate", "flip"):
        a = tr.image_pair_views(images, labels, transform)
        b = jr.image_pair_views(images, labels, transform)
        for view in b:
            for vid in b[view]:
                np.testing.assert_array_equal(a[view][vid]["data"], b[view][vid]["data"])


@pytest.mark.parametrize("shared", [False, True])
def test_sharded_experiment_matches_jax(shared):
    views = tr.gaussian_pair_views(nclasses=6, per_class=12, num_layers=1,
                                   noise=0.2, seed=11)
    kw = dict(num_shards=2, shared_clustering=shared, ncentroids=6, seed=11)
    got = tsh.run_sharded_experiment(views, device="cpu", **kw)
    want = jsh.run_sharded_experiment(views, **kw)
    assert got == want


def test_compare_shards_matches_jax():
    views = tr.gaussian_pair_views(nclasses=6, per_class=12, num_layers=1,
                                   noise=0.2, seed=12)
    got = tsh.compare_shards(views, 3, ncentroids=6, seed=12, shard_method="contiguous",
                             device="cpu")
    want = jsh.compare_shards(views, 3, ncentroids=6, seed=12, shard_method="contiguous")
    assert got == want
    for n, method in ((30, "contiguous"), (31, "random")):
        for a, b in zip(tsh.shard_split(n, 4, np.random.RandomState(0), method),
                        jsh.shard_split(n, 4, np.random.RandomState(0), method)):
            np.testing.assert_array_equal(a, b)


def test_load_option_grid_matches_jax(tmp_path):
    ref = [
        [{"measure_type": "mi"}, {"measure": "efficient_batch_mi"}],
        [{"cluster_pairing": "combination", "clustering_func_type": "sgd_kmeans"},
         {"clustering_func_type": "faiss_kmeans", "nclusters": 8}],
        [{"nexprs": 2, "num_shards": None, "batch_size": 100, "selection_size": 25}],
        [{"data_name": "image_pair_mnist_sound"}],
    ]
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    (tmp_path / "dict.json").write_text(json.dumps(
        {"measure": ["mi", "ami"], "seed": [3], "ncentroids": [4, 6]}))
    with pytest.warns(UserWarning, match="dropped"):
        got = tr.load_option_grid(tmp_path / "ref.json")
    with pytest.warns(UserWarning, match="dropped"):
        want = jr.load_option_grid(tmp_path / "ref.json")
    assert len(got) == 8 and got == want
    assert tr.load_option_grid(tmp_path / "dict.json") == \
        jr.load_option_grid(tmp_path / "dict.json")


def test_scipy_kmeans_alias_runs_the_scipy_frontend(tmp_path):
    """A deliberate divergence: the JAX package maps the reference's
    ``clustering_func_type: scipy_kmeans`` to ``sklearn++``, which no
    frontend has, so such a grid dies with ``KeyError`` there; the port maps
    it to ``scipy``."""
    (tmp_path / "g.json").write_text(json.dumps(
        [[{"clustering_func_type": "scipy_kmeans", "nclusters": 4}]]))
    (job,) = tr.load_option_grid(tmp_path / "g.json")
    assert job == {"clustering_method": "scipy", "ncentroids": 4, "seed": 0}
    (jax_job,) = jr.load_option_grid(tmp_path / "g.json")
    assert jax_job["clustering_method"] == "sklearn++"
    views = tr.gaussian_pair_views(seed=0, **SMALL)
    with pytest.raises(KeyError, match="sklearn"):
        jr.run_experiment(views=views, **jax_job)
    got = tr.run_experiment(views=views, device="cpu", **job)
    want = jr.run_experiment(views=views, **dict(jax_job, clustering_method="scipy"))
    assert got["selection"] == want["selection"]


GRID = {"seed": [0, 2], "ncentroids": [6], "clustering_method": ["sklearn"],
        "optimizer": ["efficient_greedy"], "device": ["cpu"]}


def test_grid_search_pool_equals_inline(tmp_path):
    views = tr.gaussian_pair_views(**ONE)
    inline = tr.grid_search(GRID, views=views, num_workers=1)
    pooled = tr.grid_search(GRID, out_dir=tmp_path, views=views, num_workers=2)
    assert len(pooled) == 2 and pooled == inline
    assert len(list(tmp_path.glob("result_*.pkl"))) == 2
    want = jr.grid_search({k: v for k, v in GRID.items() if k != "device"},
                          views=views, num_workers=1)
    assert [r["selection"] for r in inline] == [r["selection"] for r in want]


class _DiesWhenUnpickled:
    """A job value whose unpickling ends the worker process at once."""

    def __reduce__(self):
        return (os._exit, (1,))


def test_killed_grid_worker_raises_and_does_not_hang():
    from concurrent.futures.process import BrokenProcessPool

    jobs = [{"seed": _DiesWhenUnpickled(), "device": "cpu"},
            {"seed": 1, "device": "cpu"}]
    t0 = time.time()
    with pytest.raises(BrokenProcessPool):
        tr.grid_search(job_kwargs=jobs, num_workers=2,
                       views=tr.gaussian_pair_views(seed=0, **SMALL))
    assert time.time() - t0 < 60


def test_grid_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.grid_search({"seed": [0, 1]})


def _printed(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


def test_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    """Both CLIs on the same seed. The default ``sgd`` frontend draws from
    ``torch.Generator`` in the port and ``jax.random`` in the JAX package,
    so the runs compare on the host frontends."""
    from acav100m_torch.cli import main as port_main
    from acav100m_tpu.cli import main as jax_main

    # the default views have four clusterings, whose greedy MI steps tie
    # (see EXPERIMENTS): efficient_batch and pca_rank at seeds that decide
    for args in (["seed=1", "clustering_method=scipy", "optimizer=efficient_batch"],
                 ["seed=2", "clustering_method=sklearn", "optimizer=pca_rank",
                  "measure=pca"]):
        got = _printed(port_main, ["retrieval", "device=cpu", *args,
                                   "--out_path", str(tmp_path / "r.pkl")], capsys)
        want = _printed(jax_main, ["retrieval", *args], capsys)
        assert got == want and got[0].startswith("precision=")
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"measure": ["pca", "pca_l2"], "ncentroids": [4],
                                "seed": [5], "clustering_method": ["sklearn"],
                                "optimizer": ["pca_rank"]}))
    got = _printed(port_main, ["retrieval", "--grid", str(grid), "device=cpu",
                               "--out_path", str(tmp_path / "port")], capsys)
    want = _printed(jax_main, ["retrieval", "--grid", str(grid),
                               "--out_path", str(tmp_path / "jax")], capsys)
    assert len(got) == 2 and got == want
    assert len(list((tmp_path / "port").glob("result_*.pkl"))) == 2


def test_cli_takes_num_workers_only_with_a_grid(tmp_path):
    from acav100m_torch.cli import main

    with pytest.raises(SystemExit, match="num_workers sizes the --grid pool"):
        main(["retrieval", "device=cpu", "num_workers=2",
              "--out_path", str(tmp_path / "r.pkl")])
    assert not (tmp_path / "r.pkl").exists()


def test_cli_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from acav100m_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["retrieval"])
