"""The slice as a whole on the CPU: ``fixtures`` shards, then the port's
``extract`` against the JAX package's with the same weights (rows, row
order, keys and taps), and the port's CLI end to end (fixtures -> extract
-> cluster -> select) against the JAX chain's row count."""

from collections import OrderedDict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from acav100m_tpu import cli as jcli
from acav100m_tpu.models import slowfast as jsf
from acav100m_tpu.models import vggish as jv
from acav100m_tpu.models.zoo import save_flax_npz
from acav100m_tpu.pipeline import feature_extraction as jfe
from acav100m_tpu.utils.io import load_pickle
from acav100m_torch import cli as tcli
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models import vggish as tv
from acav100m_torch.pipeline import feature_extraction as tfe

from .torch_parity import random_variables

torch.set_num_threads(1)

SPEC = "shard-{000000..000001}"
CLUSTER = ["data.batch_size=4", "clustering.ncentroids=4"]
SELECT = ["subset.ratio=0.875", "batch.batch_size=6", "batch.selection_size=4"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    tcli.main(["fixtures", str(root / "clips"), "--size=16"])
    jcli.main(["fixtures", str(root / "jax_clips"), "--size=16"])
    return root


@pytest.fixture(scope="module")
def variables():
    sf = jax.eval_shape(
        lambda: jsf.LayerSlowFast().init(jax.random.PRNGKey(0), num_frames=8, size=16))
    vg = jax.eval_shape(lambda: jv.LayerVggish().init(jax.random.PRNGKey(0), 32000))
    return {"layer_vggish": random_variables(vg, seed=5),
            "layer_slowfast": random_variables(sf, seed=6)}


def test_fixtures_match_jax(clips):
    for name in ("shard-000000.tar", "shard-000001.tar", "shard-000000.json"):
        assert (clips / "clips" / name).read_bytes() == (clips / "jax_clips" / name).read_bytes()


def _extract_cfg(mod, root, out, **extra):
    return mod.get_config({"data.media.path": f"{root}/clips/{SPEC}.tar",
                           "data.output.path": str(out), "data.batch_size": 4,
                           "data.media.num_frames": 8, **extra})


@pytest.fixture(scope="module")
def extracted(clips, variables):
    jmodels = OrderedDict([("layer_vggish", jv.LayerVggish()),
                           ("layer_slowfast", jsf.LayerSlowFast())])
    jfe.run_extraction(_extract_cfg(jfe, clips, clips / "jax_features"),
                       models=jmodels, params=variables)
    tmodels = OrderedDict([("layer_vggish", tv.LayerVggish()),
                           ("layer_slowfast", tsf.LayerSlowFast())])
    tmodels["layer_vggish"].load_state_dict(tv.state_dict_from_flax(variables["layer_vggish"]))
    tmodels["layer_slowfast"].load_state_dict(
        tsf.state_dict_from_flax(variables["layer_slowfast"]))
    tfe.run_extraction(_extract_cfg(tfe, clips, clips / "torch_features",
                                    **{"computation.device": "cpu"}), models=tmodels)
    return clips


def test_extract_matches_jax(extracted):
    jdir, tdir = extracted / "jax_features", extracted / "torch_features"
    names = sorted(p.name for p in jdir.glob("shard-*.pkl"))
    assert names == ["shard-000000.pkl", "shard-000001.pkl"]
    assert sorted(p.name for p in tdir.glob("shard-*.pkl")) == names
    assert not list(tdir.glob("*_cache.pkl"))
    assert len(list(tdir.glob("log_*.json"))) == 1
    for name in names:
        jrows, trows = load_pickle(jdir / name), load_pickle(tdir / name)
        assert [r["filename"] for r in trows] == [r["filename"] for r in jrows]
        for jr, tr in zip(jrows, trows):
            assert set(tr) == set(jr)
            assert (tr["shard_name"], tr["shard_size"]) == (jr["shard_name"], jr["shard_size"])
            for side in ("audio_features", "video_features"):
                (jf,), (tf,) = jr[side], tr[side]
                assert {k: v for k, v in tf.items() if k != "array"} == \
                    {k: v for k, v in jf.items() if k != "array"}
                assert list(tf["array"]) == list(jf["array"])
                for layer, want in jf["array"].items():
                    got = tf["array"][layer]
                    assert got.dtype == want.dtype == np.float32
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=1e-4 * np.abs(want).max())


def test_build_models_loads_flax_npz(clips, variables, tmp_path):
    path = save_flax_npz(variables["layer_slowfast"], tmp_path / "slowfast.npz")
    cpu_sf = {"computation.device": "cpu", "models": ["layer_slowfast"]}
    cfg = _extract_cfg(tfe, clips, tmp_path, **cpu_sf, **{"weights.slowfast_file": str(path)})
    models = tfe.build_models(cfg)
    assert list(models) == ["layer_slowfast"]
    want = tsf.state_dict_from_flax(variables["layer_slowfast"])
    got = models["layer_slowfast"].state_dict()
    for key, val in want.items():
        assert torch.equal(got[key], val), key
    # the seeded init mirrors flax's: every block's final BN gamma is zero
    seeded = tfe.build_models(_extract_cfg(tfe, clips, tmp_path, **cpu_sf))
    sd = seeded["layer_slowfast"].state_dict()
    assert not sd["s2.pathway0_res0.branch2.c_bn.weight"].any()
    assert sd["s2.pathway0_res0.branch2.b_bn.weight"].eq(1).all()
    # int8 loads the same checkpoint (it has no observer state) and runs
    # s2..s5 as QuantResBlocks; an unknown quant raises
    quant = tfe.build_models(_extract_cfg(tfe, clips, tmp_path, **cpu_sf, **{
        "weights.slowfast_file": str(path), "computation.quant": "int8"}))["layer_slowfast"]
    got = quant.state_dict()
    assert all(torch.equal(got[key], val) for key, val in want.items())
    assert isinstance(quant.s2.pathway0_res0, tsf.QuantResBlock) and not quant.s2.fused_slow
    with pytest.raises(ValueError):
        tfe.build_models(_extract_cfg(tfe, clips, tmp_path, **{
            "computation.device": "cpu", "computation.quant": "int16"}))


def test_port_cli_end_to_end(extracted):
    root = extracted
    cpu = "computation.device=cpu"
    out = root / "port_chain"
    tcli.main(["fixtures", str(out / "clips"), "--size=16"])
    tcli.main(["extract", f"data.media.path={out}/clips/{SPEC}.tar",
               f"data.output.path={out}/features", "data.batch_size=4",
               "data.media.num_frames=8", cpu])
    tcli.main(["cluster", f"data.path={out}/features/{SPEC}.pkl",
               f"data.output.path={out}/clusters", *CLUSTER, cpu])
    tcli.main(["select", f"data.path={out}/clusters/{SPEC}.pkl",
               f"data.output.path={out}/output.csv", f"data.meta.path={out}/clips",
               *SELECT, cpu])
    # the JAX chain's stages 5 and 6 on its own features, same overrides
    jout = root / "jax_chain"
    jcli.main(["cluster", f"data.path={root}/jax_features/{SPEC}.pkl",
               f"data.output.path={jout}/clusters", *CLUSTER])
    jcli.main(["select", f"data.path={jout}/clusters/{SPEC}.pkl",
               f"data.output.path={jout}/output.csv", f"data.meta.path={root}/clips",
               *SELECT])
    port_rows = Path(out / "output.csv").read_text().splitlines()
    jax_rows = Path(jout / "output.csv").read_text().splitlines()
    assert len(port_rows) == len(jax_rows) == 7  # round(0.875 * 8)
    for row in port_rows:
        shard, fname, vid, _ = row.split(",", 3)
        assert shard.startswith("shard-") and fname.endswith(".npz") and vid.startswith("vid")
