"""Stage 4 on mp4 shards: both packages' ``run_extraction`` with
``data.decoder=native`` over the same two shards of mpeg4 + AAC clips and
the same weights, the port decoding in two spawned workers. Arrival is
unordered there, so rows are matched by filename; every tap agrees within
1e-4 of its max, the tolerance of ``test_extract_matches_jax``. The test
runs under a time limit of its own, so a hung decode worker fails it
instead of stalling the run."""

import io
import json
import tarfile
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from acav100m_tpu.models import slowfast as jsf
from acav100m_tpu.models import vggish as jv
from acav100m_tpu.pipeline import feature_extraction as jfe
from acav100m_tpu.utils.io import load_pickle
from acav100m_torch.data import native_av
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models import vggish as tv
from acav100m_torch.pipeline import feature_extraction as tfe

from .torch_parity import random_variables

torch.set_num_threads(1)

SPEC = "shard-{000000..000001}"
LIMIT_S = 300  # seconds a test, read by tests/time_limit.py


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    if not native_av.available():
        pytest.skip("FFmpeg's libraries or g++ are missing: native/avio.cc does not build")
    root = tmp_path_factory.mktemp("mp4")
    rng = np.random.RandomState(0)
    t = np.arange(4 * 22050) / 22050
    for si in range(2):
        meta = []
        with tarfile.open(root / f"shard-{si:06d}.tar", "w") as tf:
            for ci in range(3):
                # 4 s at 8 fps of 48x32 frames; AAC at 22.05 kHz, one tone a clip
                frames = rng.randint(0, 60, (32, 32, 48, 3)).astype(np.uint8)
                frames[..., ci % 3] += np.uint8(100 + 20 * si)
                audio = (0.4 * np.sin(2 * np.pi * (220.0 + 110 * (3 * si + ci)) * t))
                path = root / "clip.mp4"
                assert native_av.encode_mp4(path, frames, fps=8.0,
                                            audio=audio.astype(np.float32), sample_rate=22050)
                data = path.read_bytes()
                fname = f"clip_{si:03d}_{ci:03d}.mp4"
                info = tarfile.TarInfo(fname)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                meta.append({"filename": fname, "id": f"v{si}{ci}", "segment": [0.0, 4.0]})
        (root / f"shard-{si:06d}.json").write_text(json.dumps(meta))
    return root


@pytest.fixture(scope="module")
def variables():
    sf = jax.eval_shape(
        lambda: jsf.LayerSlowFast().init(jax.random.PRNGKey(0), num_frames=8, size=16))
    vg = jax.eval_shape(lambda: jv.LayerVggish().init(jax.random.PRNGKey(0), 32000))
    return {"layer_vggish": random_variables(vg, seed=7),
            "layer_slowfast": random_variables(sf, seed=8)}


def _cfg(mod, root, out, **extra):
    return mod.get_config({"data.media.path": f"{root}/{SPEC}.tar",
                           "data.output.path": str(out), "data.batch_size": 4,
                           "data.media.num_frames": 8, "data.media.size": 32,
                           "data.decoder": "native", **extra})


def test_mp4_extract_pooled_matches_jax(shards, variables):
    jmodels = OrderedDict([("layer_vggish", jv.LayerVggish()),
                           ("layer_slowfast", jsf.LayerSlowFast())])
    jfe.run_extraction(_cfg(jfe, shards, shards / "jax"), models=jmodels, params=variables)
    tmodels = OrderedDict([("layer_vggish", tv.LayerVggish()),
                           ("layer_slowfast", tsf.LayerSlowFast())])
    tmodels["layer_vggish"].load_state_dict(tv.state_dict_from_flax(variables["layer_vggish"]))
    tmodels["layer_slowfast"].load_state_dict(
        tsf.state_dict_from_flax(variables["layer_slowfast"]))
    tfe.run_extraction(_cfg(tfe, shards, shards / "torch", **{
        "computation.device": "cpu", "computation.num_workers": 2}), models=tmodels)
    for name in ("shard-000000.pkl", "shard-000001.pkl"):
        jrows = {r["filename"]: r for r in load_pickle(shards / "jax" / name)}
        trows = {r["filename"]: r for r in load_pickle(shards / "torch" / name)}
        assert len(jrows) == 3 and trows.keys() == jrows.keys()
        for fname, jr in jrows.items():
            tr = trows[fname]
            for side in ("audio_features", "video_features"):
                (jf,), (tf,) = jr[side], tr[side]
                for layer, want in jf["array"].items():
                    np.testing.assert_allclose(tf["array"][layer], want, rtol=0,
                                               atol=1e-4 * np.abs(want).max(),
                                               err_msg=f"{fname} {side} {layer}")
    # different tones give different audio embeddings: the AAC stream was decoded
    emb = [r["audio_features"][0]["array"]["layer_4"]
           for r in load_pickle(shards / "torch" / "shard-000000.pkl")]
    assert not np.allclose(emb[0], emb[1])
