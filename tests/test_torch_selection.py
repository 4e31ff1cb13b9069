"""Stage 6 driver: ``select`` of the port against the JAX package's on the
same JAX-written assignment pkls, run manifest and shard jsons gives a
byte-identical ``output.csv``, in float64 and in float32.

The assignments come from a seeded latent-class model (each clip a class,
each of the ten clusterings a noisy function of it), like real stage-5
output. A cache that holds only the start singleton makes many distinct
candidates tie mathematically, and rounding then picks among them in each
framework; the fixture's seed is one whose decisions both frameworks make
alike (see tests/test_torch_mi.py)."""

import json

import numpy as np
import pytest
import torch

from acav100m_tpu.pipeline import subset_selection as jss
from acav100m_tpu.utils.io import dump_pickle
from acav100m_tpu.utils.manifests import write_run_manifest
from acav100m_torch.pipeline import subset_selection as tss

torch.set_num_threads(1)

SHARDS, ROWS, C = 2, 40, 8
SPEC = "shard-{000000..000001}"
SEED = 0


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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
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


def test_unported_modes_raise(assignments):
    cfg = tss.get_config({"data.path": f"{assignments}/clusters/{SPEC}.pkl",
                          "chunk_size": 1, "computation.device": "cpu"})
    with pytest.raises(NotImplementedError):
        tss.run(cfg)
