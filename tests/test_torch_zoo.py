"""The port's checkpoint loading against the JAX package's, at full width:
PySlowFast ``.pyth``, the published caffe2 ``.pkl`` form of
SLOWFAST_8x8_R50 and a torchvggish ``.pth``. ``convert`` writes the same
arrays as the JAX package's ``convert``, the caffe2 names round-trip over
the whole two-pathway topology, and ``build_models`` loads each checkpoint
to the state dict of the JAX conversion."""

import json
import pickle

import numpy as np
import pytest
import torch

from acav100m_tpu.models import zoo as jzoo
from acav100m_torch import cli as tcli
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models import vggish as tv
from acav100m_torch.models import zoo as tzoo
from acav100m_torch.pipeline import feature_extraction as tfe

from .synthetic import make_pyslowfast_state_dict

torch.set_num_threads(1)


def make_vggish_state_dict(seed=3):
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in tv.LayerVggish().state_dict().items()}
    return {k: torch.from_numpy(0.01 * rng.standard_normal(s, dtype=np.float32))
            for k, s in shapes.items()}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    sd = make_pyslowfast_state_dict(np.random.RandomState(1))
    extra = {"head.projection.weight": torch.zeros(400, 2304),
             "s1.pathway0_stem.bn.num_batches_tracked": torch.tensor(7)}
    torch.save({"model_state": {**{k: torch.from_numpy(v) for k, v in sd.items()}, **extra},
                "epoch": 196, "optimizer_state": {"state": {}}}, root / "slowfast.pyth")
    # the published form: a latin1 pickle of {'blobs': {caffe2 name: array}}
    # with momentum blobs and the classification head beside the weights
    blobs = {tzoo.pyslowfast_to_caffe2_name(k): v for k, v in sd.items()}
    blobs["pred_w"] = np.zeros((400, 2304), np.float32)
    blobs["res2_0_branch2a_w_momentum"] = np.zeros(1, np.float32)
    with open(root / "slowfast.pkl", "wb") as f:
        pickle.dump({"blobs": blobs, "model_iter": 1}, f, protocol=2)
    torch.save(make_vggish_state_dict(), root / "vggish.pth")
    return root, sd


def test_caffe2_round_trip_over_full_topology(ckpts):
    _, sd = ckpts
    names = {k: tzoo.pyslowfast_to_caffe2_name(k) for k in sd}
    assert all(names.values())
    assert names == {k: jzoo.pyslowfast_to_caffe2_name(k) for k in sd}
    assert len(set(names.values())) == len(sd)
    back = tzoo.caffe2_to_pyslowfast({c: sd[k] for k, c in names.items()})
    assert back.keys() == sd.keys()
    assert all(np.array_equal(back[k], sd[k]) for k in sd)
    assert tzoo.is_caffe2(names.values()) and not tzoo.is_caffe2(sd)


def test_caffe2_skips_and_raises():
    blobs = {"conv1_w": np.ones((64, 3, 1, 7, 7), np.float32),
             "conv1_w_momentum": np.ones(1), "pred_b": np.ones(400), "fc_w": np.ones(1),
             "last_out_b": np.ones(1)}
    assert list(tzoo.caffe2_to_pyslowfast(blobs)) == ["s1.pathway0_stem.conv.weight"]
    assert list(jzoo.caffe2_to_pyslowfast(blobs)) == ["s1.pathway0_stem.conv.weight"]
    for mod in (tzoo, jzoo):
        with pytest.raises(ValueError, match="unmapped caffe2 blobs"):
            mod.caffe2_to_pyslowfast({**blobs, "res9_x_mystery_w": np.ones(1)})


@pytest.mark.parametrize("container", ["model_state", "state_dict", "flat", "blobs"])
def test_load_torch_checkpoint_containers(container, tmp_path):
    sd = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3), "a.bias": np.ones(2)}
    if container == "blobs":
        path = tmp_path / "c.pkl"
        with open(path, "wb") as f:
            pickle.dump({"blobs": sd}, f, protocol=2)
    else:
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        path = tmp_path / "c.pt"
        torch.save(tensors if container == "flat" else {container: tensors, "epoch": 3}, path)
    got, want = tzoo.load_torch_checkpoint(path), jzoo.load_torch_checkpoint(path)
    assert got.keys() == want.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == want[k].dtype == v.dtype


CASES = [("slowfast", "slowfast.pyth", "pyslowfast"), ("slowfast", "slowfast.pkl", "caffe2"),
         ("vggish", "vggish.pth", "vggish")]


@pytest.fixture(scope="module")
def converted(ckpts):
    """Each checkpoint through the JAX package's convert and the port's CLI."""
    root, _ = ckpts
    out = {}
    for model, name, _ in CASES:
        jm = jzoo.convert_checkpoint(model, root / name, root / f"jax-{name}.npz")
        tcli.main(["convert", model, str(root / name), str(root / f"torch-{name}.npz")])
        tm = json.loads((root / f"torch-{name}.npz.json").read_text())
        out[name] = (jm, tm)
    return out


@pytest.mark.parametrize("model,name,fmt", CASES)
def test_convert_matches_jax(ckpts, converted, model, name, fmt):
    root, _ = ckpts
    jm, tm = converted[name]
    with np.load(root / f"jax-{name}.npz") as jz, np.load(root / f"torch-{name}.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for key in jz.files:
            assert tz[key].dtype == jz[key].dtype, key
            np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)
    # the output hashes differ by the zip entries' timestamps only
    paths = ("input", "output", "output_sha256")
    assert {k: v for k, v in tm.items() if k not in paths} == \
        {k: v for k, v in jm.items() if k not in paths}
    assert tm["format"] == fmt
    assert tm["output_sha256"] == tzoo.sha256_file(root / f"torch-{name}.npz")


def test_build_models_loads_checkpoints(ckpts, converted):
    root, _ = ckpts
    want_v = tv.state_dict_from_flax(jzoo.load_flax_npz(root / "jax-vggish.pth.npz"))
    for name in ("slowfast.pyth", "slowfast.pkl", "jax-slowfast.pkl.npz"):
        cfg = tfe.get_config({"computation.device": "cpu", "data.media.path": "x",
                              "weights.slowfast_file": str(root / name),
                              "weights.vggish_file": str(root / "vggish.pth")})
        models = tfe.build_models(cfg)
        want_sf = tsf.state_dict_from_flax(jzoo.load_flax_npz(root / "jax-slowfast.pyth.npz"))
        for model, want in (("layer_slowfast", want_sf), ("layer_vggish", want_v)):
            got = models[model].state_dict()
            assert got.keys() == want.keys()
            for key, val in want.items():
                assert torch.equal(got[key], val), (name, key)
