"""Stage 5 driver: the port's ``run_clustering`` against the JAX package's
on JAX-written feature pkls, both resuming from the same JAX-written
``cache_epoch_0`` past warmup (so no random draw matters). Assignment pkls
must be identical, and centroid caches must cross-load both ways."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.ops import kmeans as jk
from acav100m_tpu.pipeline import clustering as jcl
from acav100m_tpu.utils.io import dump_pickle, load_pickle, make_feature_row
from acav100m_torch.pipeline import clustering as tcl

torch.set_num_threads(1)

AUDIO_DIMS = [6, 5, 4, 7, 3]
VIDEO_DIMS = [8, 6, 9, 5, 12]
K, ROWS, SHARDS = 4, 48, 2
SPEC = "shard-{000000..000001}"


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage5")
    rng = np.random.RandomState(0)
    protos = {d: rng.randn(K, d) * 2 for d in set(AUDIO_DIMS + VIDEO_DIMS)}
    for si in range(SHARDS):
        rows = []
        for ci in range(ROWS):
            lab = rng.randint(K)
            per_model = [
                {"model_key": key, "extractor_name": key, "dataset": "x",
                 "array": [(protos[d][lab] + rng.randn(d)).astype(np.float32)
                           for d in dims]}
                for key, dims in (("layer_vggish", AUDIO_DIMS),
                                  ("layer_slowfast", VIDEO_DIMS))]
            rows.append(make_feature_row(f"clip_{si}_{ci:03d}.npz", f"shard-{si:06d}",
                                         ROWS, per_model, ["layer_vggish"]))
        dump_pickle(rows, root / "features" / f"shard-{si:06d}.pkl")
    # a JAX-written epoch-0 cache, far past warmup
    cfg = jcl.get_config({"data.path": f"{root}/features/{SPEC}.pkl",
                          "data.output.path": str(root / "jax_cache")})
    types, dims = jcl.discover_types(
        [root / "features" / f"shard-{si:06d}.pkl" for si in range(SHARDS)])
    state = jk.init_state(jax.random.PRNGKey(0), dims, K)
    first = jcl.stack_batch(load_pickle(root / "features" / "shard-000000.pkl")[:K],
                            types, max(dims))  # (M, K, Dmax): one row per center
    state = state._replace(
        centers=jnp.asarray(first) * state.d_mask[:, None, :],
        counts=jnp.asarray(rng.randint(20, 200, (len(dims), K)).astype(np.float32)),
        count=jnp.asarray(5000, jnp.int32))
    jcl.save_centroids(cfg, 0, state, types, dims)
    return root


def _cfg(mod, root, out, **extra):
    over = {"data.path": f"{root}/features/{SPEC}.pkl", "data.output.path": str(out),
            "data.batch_size": 16, "clustering.ncentroids": K,
            "clustering.cached_epoch": 0, "clustering.resume_training": True}
    over.update(extra)
    return mod.get_config(over)


def _run_both(root, tag):
    outs = {}
    for name, mod, extra in (("jax", jcl, {}), ("torch", tcl, {"computation.device": "cpu"})):
        out = root / f"{tag}_{name}"
        shutil.copytree(root / "jax_cache", out)
        mod.run_clustering(_cfg(mod, root, out, **extra))
        outs[name] = out
    return outs


def test_assignment_pkls_identical(features):
    outs = _run_both(features, "resume")
    for si in range(SHARDS):
        name = f"shard-{si:06d}.pkl"
        jrows, trows = load_pickle(outs["jax"] / name), load_pickle(outs["torch"] / name)
        assert len(trows) == ROWS
        assert trows == jrows
    for out in outs.values():
        assert len(list(out.glob("log_*.json"))) == 1
    # both re-train epochs 0 and 1 and save their caches
    for epoch in (0, 1):
        jc = load_pickle(outs["jax"] / f"cache_epoch_{epoch}_{SPEC}.pkl")
        tc = load_pickle(outs["torch"] / f"cache_epoch_{epoch}_{SPEC}.pkl")
        assert set(tc) == set(jc) and set(tc["kmeans"]) == set(jc["kmeans"])
        assert tc["types"] == jc["types"] and tc["dims"] == jc["dims"]
        np.testing.assert_array_equal(tc["kmeans"]["counts"], jc["kmeans"]["counts"])
        assert tc["kmeans"]["count"] == jc["kmeans"]["count"]
        np.testing.assert_allclose(tc["kmeans"]["centers"], jc["kmeans"]["centers"],
                                   rtol=0, atol=1e-5)


def test_caches_cross_load(features):
    outs = _run_both(features, "cross")
    path = outs["torch"] / f"cache_epoch_1_{SPEC}.pkl"
    jstate, jtypes, jdims = jcl.load_centroids(path)  # a port cache in JAX
    tstate, ttypes, tdims = tcl.load_centroids(path)
    assert jtypes == ttypes and jdims == tdims
    np.testing.assert_array_equal(np.asarray(jstate.centers), tstate.centers.numpy())
    assert int(jstate.count) == tstate.count
    path = outs["jax"] / f"cache_epoch_1_{SPEC}.pkl"
    jstate, _, _ = jcl.load_centroids(path)  # a JAX cache in the port
    tstate, _, _ = tcl.load_centroids(path)
    np.testing.assert_array_equal(np.asarray(jstate.centers), tstate.centers.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.d_mask), tstate.d_mask.numpy())
    # the port resumes from the JAX cache without retraining
    out = features / "assign_only"
    shutil.copytree(outs["jax"], out, ignore=shutil.ignore_patterns("shard-*", "log_*"))
    tcl.run_clustering(_cfg(tcl, features, out, **{
        "computation.device": "cpu", "clustering.cached_epoch": 1,
        "clustering.resume_training": False}))
    jout = features / "assign_only_jax"
    shutil.copytree(outs["jax"], jout, ignore=shutil.ignore_patterns("shard-*", "log_*"))
    jcl.run_clustering(_cfg(jcl, features, jout, **{
        "clustering.cached_epoch": 1, "clustering.resume_training": False}))
    for si in range(SHARDS):
        name = f"shard-{si:06d}.pkl"
        assert load_pickle(out / name) == load_pickle(jout / name)


def test_buffered_shuffle_matches_jax():
    import random

    for n, buf in ((1, 4), (10, 3), (250, 100), (57, 1000)):
        a = list(jcl.buffered_shuffle(range(n), buf, random.Random(3)))
        b = list(tcl.buffered_shuffle(range(n), buf, random.Random(3)))
        assert a == b


def test_find_centroid_cache_subset(tmp_path):
    cfg = tcl.get_config({"data.path": f"{tmp_path}/shard-{{000000..000003}}.pkl",
                          "data.output.path": str(tmp_path)})
    (tmp_path / "cache_epoch_2_shard-{000000..000001}.pkl").write_bytes(b"")
    (tmp_path / "cache_epoch_2_shard-{000000..000009}.pkl").write_bytes(b"")
    assert tcl.find_centroid_cache(cfg, 2).name == "cache_epoch_2_shard-{000000..000001}.pkl"
    jcfg = jcl.get_config({"data.path": cfg.data.path, "data.output.path": str(tmp_path)})
    assert jcl.find_centroid_cache(jcfg, 2) == tcl.find_centroid_cache(cfg, 2)
