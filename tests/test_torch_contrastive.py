"""Contrastive selection: the port's probe, its training trajectory, its
scores and its csvs against the JAX package's, from the same initial
parameters (the JAX package's form, carried across by ``probe_from_jax``).

Tolerances: the loss within 1e-6 of the JAX package's, relative, and its
gradients within 1e-6 (largest |gradient| about 1e-2; 1.3e-8 measured); the
parameters after 3 epochs of 3 steps within 1e-5 of the largest |parameter|
(4.4e-6 with accumulated gradients and 4.8e-6 without, measured: float32
rounding in the two AdamW implementations and the matmuls); alignment scores within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.pipeline import contrastive_selection as jcs
from acav100m_tpu.utils.io import dump_pickle
from acav100m_torch.pipeline import contrastive_selection as tcs

torch.set_num_threads(1)

V, DV, DA = 96, 64, 32


def _features(seed=0, v=V, matched=48):
    rng = np.random.RandomState(seed)
    latent = rng.randn(v, 16)
    video = np.concatenate([latent, rng.randn(v, DV - 16)], axis=1).astype(np.float32)
    audio = np.concatenate([latent, rng.randn(v, DA - 16)], axis=1).astype(np.float32)
    audio[matched:, :16] = rng.randn(v - matched, 16)
    return video, audio


def _jax_params(seed=0):
    params = jcs.init_probe(jax.random.PRNGKey(seed), DV, DA)
    return {k: np.asarray(v) for k, v in params.items()}


def _torch_params(probe):
    sd = {k: v.detach().cpu().numpy() for k, v in probe.state_dict().items()}
    return {"wv": sd["visual_linear.weight"].T, "bv": sd["visual_linear.bias"],
            "wa": sd["audio_linear.weight"].T, "ba": sd["audio_linear.bias"]}


def test_probe_from_jax_and_loss_gradients():
    video, audio = _features()
    params = _jax_params()
    probe = tcs.probe_from_jax(params)
    for key, val in _torch_params(probe).items():
        np.testing.assert_array_equal(val, params[key])
    v, a = video[:32], audio[:32]
    jloss, jgrads = jax.value_and_grad(jcs.probe_loss)(
        {k: jnp.asarray(x) for k, x in params.items()}, jnp.asarray(v), jnp.asarray(a))
    tloss = tcs.probe_loss(probe, torch.from_numpy(v), torch.from_numpy(a))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    tgrads = {"wv": probe.visual_linear.weight.grad.numpy().T,
              "bv": probe.visual_linear.bias.grad.numpy(),
              "wa": probe.audio_linear.weight.grad.numpy().T,
              "ba": probe.audio_linear.bias.grad.numpy()}
    for key, g in jgrads.items():
        g = np.asarray(g)
        assert np.abs(tgrads[key] - g).max() <= 1e-6, key
    with torch.no_grad():
        tacc = float(tcs.probe_accuracy(probe, torch.from_numpy(v), torch.from_numpy(a)))
    jacc = float(jcs.probe_accuracy({k: jnp.asarray(x) for k, x in params.items()},
                                    jnp.asarray(v), jnp.asarray(a)))
    assert tacc == pytest.approx(jacc)


@pytest.mark.parametrize("accumulate_grads", [True, False])
def test_train_probe_trajectory_matches_jax(accumulate_grads):
    video, audio = _features()
    params = _jax_params()
    kwargs = dict(num_epochs=3, batch_size=40, base_lr=1e-2, seed=3, params=params,
                  accumulate_grads=accumulate_grads)
    jp = jcs.train_probe(video, audio, **kwargs)
    probe = tcs.train_probe(video, audio, device="cpu", **kwargs)
    tp = _torch_params(probe)
    scale = max(np.abs(np.asarray(x)).max() for x in jp.values())
    moved = max(np.abs(np.asarray(jp[k]) - params[k]).max() for k in params)
    assert moved > 1e3 * 1e-5 * scale  # the probe trained well past the tolerance
    for key, val in jp.items():
        assert np.abs(tp[key] - np.asarray(val)).max() <= 1e-5 * scale, key
    jscores = jcs.alignment_scores(jp, video, audio)
    tscores = tcs.alignment_scores(probe, video, audio)
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1e-5)
    metas = [{"filename": f"c{i:03d}.mp4", "shard_name": "shard-000000"} for i in range(V)]
    rows = [[(m["shard_name"], m["filename"]) for m in mod.rank_and_cut(metas, scores, 0.25)]
            for mod, scores in ((tcs, tscores), (jcs, jscores))]
    assert rows[0] == rows[1] and len(rows[0]) == 24


def test_lr_func_linear_matches_jax():
    for step in range(6):
        for warm in (0, 1, 3):
            assert tcs.lr_func_linear(step, 5, warm) == jcs.lr_func_linear(step, 5, warm)


def test_init_probe_is_seeded_and_device_free():
    a, b = tcs.init_probe(DV, DA, seed=5), tcs.init_probe(DV, DA, seed=5)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    bound = 1.0 / np.sqrt(DV)
    assert float(a.visual_linear.weight.abs().max()) <= bound


def _write_shard(root, video, audio):
    rows = [{"filename": f"clip{i:03d}.mp4", "shard_name": "shard-000000",
             "video_features": [{"model_key": "layer_slowfast",
                                 "array": {"layer_3": video[i][:8], "layer_4": video[i]}}],
             "audio_features": [{"model_key": "layer_vggish",
                                 "array": {"layer_4": audio[i]}}]}
            for i in range(len(video))]
    return dump_pickle(rows, root / "shard-000000.pkl")


def test_run_contrastive_selection_matches_jax(tmp_path, monkeypatch):
    video, audio = _features(1)
    shard = _write_shard(tmp_path, video, audio)
    tv, ta, tm = tcs.load_penultimate_features([shard])
    jv, ja, jm = jcs.load_penultimate_features([shard])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta, ja)
    assert tm == jm
    params = _jax_params(2)
    monkeypatch.setattr(jcs, "init_probe",
                        lambda key, vd, ad: {k: jnp.asarray(x) for k, x in params.items()})
    monkeypatch.setattr(tcs, "init_probe", lambda vd, ad, seed=0: tcs.probe_from_jax(params))
    kwargs = dict(subset_ratio=0.25, num_epochs=3, batch_size=32, base_lr=5e-3)
    jout, jn = jcs.run_contrastive_selection([shard], tmp_path / "jax.csv", **kwargs)
    tout, tn = tcs.run_contrastive_selection([shard], tmp_path / "torch.csv", device="cpu",
                                             **kwargs)
    assert tn == jn == 24
    assert tout.read_bytes() == jout.read_bytes()


def test_merge_contrastive_csvs_byte_identical(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for c in range(3):
        lines = [f"shard-{c:06d},clip{rng.randint(40):03d}.mp4,{rng.randn():.6f}"
                 for _ in range(20)]
        lines.append(f"shard-{c:06d},tie.mp4,0.5")  # equal scores: filename order
        lines.append(f"shard-{c:06d},atie.mp4,0.5")
        paths.append(tmp_path / f"cache_{c}.csv")
        paths[-1].write_text("\n".join(lines) + "\n")
    for kwargs in ({}, {"subset_size": 7}, {"subset_ratio": 0.5, "dedupe": False}):
        jout, jn = jcs.merge_contrastive_csvs(paths, tmp_path / "jax.csv", **kwargs)
        tout, tn = tcs.merge_contrastive_csvs(paths, tmp_path / "torch.csv", **kwargs)
        assert tn == jn
        assert tout.read_bytes() == jout.read_bytes()


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    video, audio = _features()
    shard = _write_shard(tmp_path, video, audio)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.run_contrastive_selection([shard], tmp_path / "out.csv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.train_probe(video, audio)
