"""int8 through stage 4's ``run_extraction`` on the CPU: the port's
``run_extraction`` with ``computation.quant=int8`` calibrates once, on its
first batch, and writes the standard schema, against the JAX package's on the
same npz shards and weights; then the port's curation gate (the JAX
package's ``tests/test_quant.py:216-311``): int8 against fp features
through cluster and select, assignment agreement >= 0.75 and subset overlap
>= 0.6.

The weights are seeded flax trees with non-zero BN gammas (a seeded init's
final gammas are zero, which would leave every int8 residual branch
dead). Each package calibrates on its own, and the scales differ by float32
rounding (7e-7 relative), which can move a quantized activation one step;
the taps are held to a cosine above 0.999 and a relative L2 below 5e-2 per
tap (measured here: cosine at least 0.99953, relative L2 at most 3.1e-2).
The same clips through the port's fp graph set those apart from fp: the
s1_fuse tap (before any int8 stage) equals fp's; the s2 tap is within
7.9e-5 of JAX's int8 and at least 6.8e-3 from fp (held to a twentieth of
the fp distance); the s3..s5 taps are at least 1.5e-2 from fp (held to
5e-3), where a one-step move cascading through the stages takes the port
as far from JAX's int8 as from fp. The gate measured agreement 1.0 and
overlap 1.0 here."""

from collections import OrderedDict

import jax
import numpy as np
import torch

from acav100m_tpu.models import slowfast as jsf
from acav100m_tpu.pipeline import feature_extraction as jfe
from acav100m_torch import cli as tcli
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models.zoo import save_flax_npz
from acav100m_torch.pipeline import clustering as tpc
from acav100m_torch.pipeline import feature_extraction as tfe
from acav100m_torch.pipeline import subset_selection as tss
from acav100m_torch.utils.io import load_pickle

from .synthetic import make_shards
from .torch_parity import random_variables

torch.set_num_threads(1)

VIDEO_ONLY = {"models": ["layer_slowfast"], "model_types.audio": [],
              "model_types.visual": ["layer_slowfast"]}


def _variables(num_frames, size, seed):
    shapes = jax.eval_shape(lambda: jsf.LayerSlowFast().init(
        jax.random.PRNGKey(0), num_frames=num_frames, size=size))
    return random_variables(shapes, seed=seed)


def _rows(out_dir):
    return [r for p in sorted(out_dir.glob("shard-*.pkl")) for r in load_pickle(p)]


def _port_model(variables, **kw):
    model = tsf.LayerSlowFast(**kw)
    model.load_state_dict(tsf.state_dict_from_flax(variables))
    return model


def _counted_calibrate(model):
    """Records the shape of every batch ``model.calibrate`` is called on."""
    calls, calibrate = [], model.calibrate

    def counted(frames):
        calls.append(tuple(frames.shape))
        calibrate(frames)

    model.calibrate = counted
    return calls


def _rel(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_run_extraction_int8_calibrates_on_batch_0_and_matches_jax(tmp_path):
    tcli.main(["fixtures", str(tmp_path / "clips"), "--size=16"])
    variables = _variables(8, 16, seed=31)

    def cfg(mod, out, quant="int8", **extra):
        return mod.get_config({"data.media.path": f"{tmp_path}/clips/shard-{{000000..000001}}.tar",
                               "data.output.path": str(tmp_path / out), "data.batch_size": 4,
                               "data.media.num_frames": 8, "computation.quant": quant,
                               **VIDEO_ONLY, **extra})

    jparams = {"layer_slowfast": dict(variables)}
    jfe.run_extraction(cfg(jfe, "jax"), models={"layer_slowfast": jsf.LayerSlowFast(
        quant="int8")}, params=jparams)
    model = _port_model(variables, quant="int8")
    calls = _counted_calibrate(model)
    tfe.run_extraction(cfg(tfe, "port", **{"computation.device": "cpu"}),
                       models=OrderedDict(layer_slowfast=model))
    assert calls == [(4, 8, 16, 16, 3)]  # once, on the first batch of 4 clips
    want_q = tsf.quant_state_from_flax(jparams["layer_slowfast"])
    for key, val in model.quant_state_dict().items():
        np.testing.assert_allclose(float(val), float(want_q[key]), rtol=1e-5, err_msg=key)
    # the port's fp features of the same clips, which int8 must stand apart from
    tfe.run_extraction(cfg(tfe, "fp", quant="none", **{"computation.device": "cpu"}),
                       models=OrderedDict(layer_slowfast=_port_model(variables)))
    jrows, trows, frows = (_rows(tmp_path / d) for d in ("jax", "port", "fp"))
    assert len(trows) == 8 and [r["filename"] for r in trows] == [r["filename"] for r in jrows]
    assert [r["filename"] for r in frows] == [r["filename"] for r in trows]
    for jr, tr, fr in zip(jrows, trows, frows):
        assert set(tr) == set(jr) and not tr["audio_features"]
        (jf,), (tf,), (ff,) = jr["video_features"], tr["video_features"], fr["video_features"]
        assert {k: v for k, v in tf.items() if k != "array"} == \
            {k: v for k, v in jf.items() if k != "array"}
        assert list(tf["array"]) == list(jf["array"])
        for i, (layer, want) in enumerate(jf["array"].items()):
            got, fp = tf["array"][layer], ff["array"][layer]
            assert got.dtype == np.float32 and got.shape == want.shape
            a, b = got.astype(np.float64), want.astype(np.float64)
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            rel = _rel(got, want)
            assert cos > 0.999 and rel < 5e-2, (layer, cos, rel)
            if i == 0:  # s1_fuse: before the first int8 stage, fp in both
                np.testing.assert_array_equal(got, fp)
            elif i == 1:  # s2, the first int8 stage: JAX's int8, far from fp
                assert rel < 0.05 * _rel(got, fp), (layer, rel, _rel(got, fp))
            else:  # deeper, one-step moves cascade; still well off the fp graph
                assert _rel(got, fp) > 5e-3, (layer, _rel(got, fp))


def test_run_extraction_calibrates_an_int8_model_whatever_the_config(tmp_path):
    """The model owns the observers: an int8 model passed in ``models=`` is
    calibrated on the first batch though ``computation.quant`` is unset."""
    tcli.main(["fixtures", str(tmp_path / "clips"), "--size=16", "--num_shards=1",
               "--clips_per_shard=2"])
    model = _port_model(_variables(8, 16, seed=33), quant="int8")
    calls = _counted_calibrate(model)
    tfe.run_extraction(tfe.get_config({
        "data.media.path": f"{tmp_path}/clips/shard-000000.tar",
        "data.output.path": str(tmp_path / "port"), "data.batch_size": 2,
        "data.media.num_frames": 8, "computation.device": "cpu", **VIDEO_ONLY}),
        models=OrderedDict(layer_slowfast=model))
    assert calls == [(2, 8, 16, 16, 3)]
    assert all(float(v) > 0 for v in model.quant_state_dict().values())
    assert len(_rows(tmp_path / "port")) == 2


def test_int8_curation_gate(tmp_path):
    """The port's int8 features against its fp features through cluster and
    select (video only, 2 shards x 8 clips of 4 classes)."""
    spec = make_shards(tmp_path / "clips", num_shards=2, clips_per_shard=8, num_classes=4,
                       num_frames=8, size=32)
    weights = save_flax_npz(_variables(8, 32, seed=32), tmp_path / "slowfast.npz")
    results = {}
    for mode in ("none", "int8"):
        root = tmp_path / mode
        tfe.run_extraction(tfe.get_config({
            "data.media.path": f"{spec}.tar", "data.output.path": str(root / "features"),
            "data.batch_size": 8, "data.media.num_frames": 8, "computation.quant": mode,
            "computation.device": "cpu", "weights.slowfast_file": str(weights), **VIDEO_ONLY}))
        ccfg = tpc.get_config({
            "data.path": str(root / "features" / "shard-{000000..000001}.pkl"),
            "data.batch_size": 8, "data.output.path": str(root / "clusters"),
            "computation.shuffle_bufsize": 0, "computation.device": "cpu",
            "clustering.ncentroids": 4, "clustering.epochs": 2})
        state, types, _ = tpc.train_clusters(ccfg)
        assigns = {}
        for path in tpc.assign_clusters(ccfg, state, types):
            for row in load_pickle(path):
                assigns[row["filename"]] = {(f["model_key"], layer): int(v)
                                            for f in row["video_assignments"]
                                            for layer, v in f["array"].items()}
        tss.run_single(tss.get_config({
            "data.path": [str(p) for p in sorted((root / "clusters").glob("shard-*.pkl"))],
            "data.output.path": str(root / "output.csv"), "data.meta.path": str(tmp_path / "clips"),
            "subset.ratio": 0.5, "computation.random_seed": 0, "computation.device": "cpu"}))
        selected = {line.split(",")[1] for line in (root / "output.csv").read_text().splitlines()}
        results[mode] = assigns, selected
    (fp_a, fp_s), (q_a, q_s) = results["none"], results["int8"]
    assert set(fp_a) == set(q_a) and len(fp_a) == 16
    pairs = [(fp_a[f][t], q_a[f][t]) for f in fp_a for t in fp_a[f]]
    agreement = sum(a == b for a, b in pairs) / len(pairs)
    overlap = len(fp_s & q_s) / max(len(fp_s), 1)
    assert len(fp_s) > 0
    assert agreement >= 0.75, agreement
    assert overlap >= 0.6, (overlap, fp_s, q_s)
