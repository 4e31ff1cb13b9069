"""The port's retrieval features (``acav100m_torch.retrieval.features``)
against the JAX package's: ResNet-50 taps on the same seeded weights,
torchvision-named state dicts, the chunked pkl cache read across packages,
the log-mel audio features and the synthetic stand-in data."""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.retrieval import features as jf
from acav100m_torch.retrieval import features as tf
from tests.torch_parity import random_variables

torch.set_num_threads(1)

# relative to each tap's largest magnitude: float32 convolutions summed in
# another order over 53 layers
TAP_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def flax_variables():
    """Seeded random variables over the shapes of the JAX module's init
    (``jax.eval_shape``: the init itself runs a forward pass)."""
    shapes = jax.eval_shape(lambda: jf.ResNet50Features().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    return random_variables(shapes, seed=1)


@functools.lru_cache(maxsize=None)
def jax_extractor():
    """One JAX extractor for the module (its jit compiles once per chunk
    shape, and every chunk here pads to 16 rows)."""
    return jf.ImageFeatureExtractor(variables=flax_variables(), size=32, chunk_size=4)


def port_extractor(**kw):
    return tf.ImageFeatureExtractor(variables=flax_variables(), size=32, chunk_size=4,
                                    device="cpu", **kw)


def images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)


def assert_taps_close(got, want):
    assert sorted(got) == sorted(want) == [f"layer_{l}" for l in range(4)]
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == np.float32
        err = np.abs(got[key] - want[key]).max() / np.abs(want[key]).max()
        assert err <= TAP_RTOL, (key, err)


def test_taps_match_jax_on_seeded_weights():
    x = images(4)
    got = port_extractor().extract(x)
    assert [got[f"layer_{l}"].shape[1] for l in range(4)] == tf.LAYER_DIMS
    assert_taps_close(got, jax_extractor().extract(x))


def test_grayscale_input_promoted():
    x = images(4, seed=1)[..., 0]
    assert_taps_close(port_extractor().extract(x), jax_extractor().extract(x))


def _torchvision_state_dict(rng):
    """A torchvision ``resnet50`` state dict with random values: its names,
    ``num_batches_tracked`` and the classifier ``fc``."""
    sd = {}

    def add_bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7)

    def add_conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rng.randn(cout, cin, k, k)
                                / np.sqrt(cin * k * k)).astype(np.float32)

    add_conv("conv1", 64, 3, 7)
    add_bn("bn1", 64)
    cin = 64
    for li, nblocks in enumerate(tf.RESNET50_BLOCKS):
        dim_out = 256 * (2 ** li)
        inner = dim_out // 4
        for bi in range(nblocks):
            name = f"layer{li + 1}.{bi}"
            add_conv(f"{name}.conv1", inner, cin, 1)
            add_bn(f"{name}.bn1", inner)
            add_conv(f"{name}.conv2", inner, inner, 3)
            add_bn(f"{name}.bn2", inner)
            add_conv(f"{name}.conv3", dim_out, inner, 1)
            add_bn(f"{name}.bn3", dim_out)
            if bi == 0:
                add_conv(f"{name}.downsample.0", dim_out, cin, 1)
                add_bn(f"{name}.downsample.1", dim_out)
            cin = dim_out
    sd["fc.weight"] = rng.randn(1000, 2048).astype(np.float32)
    sd["fc.bias"] = rng.randn(1000).astype(np.float32)
    return sd


def test_torchvision_state_dict_loads_strictly_and_matches_jax_conversion():
    sd = _torchvision_state_dict(np.random.RandomState(2))
    converted = tf.convert_torchvision_resnet50(sd)
    assert not any(k.startswith("fc.") for k in converted)
    model = tf.ResNet50Features()
    model.load_state_dict(converted, strict=True)
    assert set(converted) == set(model.state_dict())
    assert int(converted["bn1.num_batches_tracked"]) == 7
    # the same weights through the JAX package's converter
    jax_vars = jf.convert_torchvision_resnet50(sd)
    x = images(4, seed=3)
    want = jf.ImageFeatureExtractor(variables=jax_vars, size=32, chunk_size=4).extract(x)
    port = tf.ImageFeatureExtractor(size=32, device="cpu")
    port.model.load_state_dict(converted)
    got = port.extract(x)
    assert_taps_close(got, want)
    # and the flax tree carried back gives the torchvision tensors
    back = tf.state_dict_from_flax(jax_vars)
    assert set(back) == set(converted)
    for k, v in converted.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


def test_state_dict_from_flax_keys_are_the_modules():
    sd = tf.state_dict_from_flax(flax_variables())
    model = tf.ResNet50Features()
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def _never(*a, **kw):
    raise AssertionError("a cached chunk was computed again")


def test_chunks_written_by_jax_load_in_port(tmp_path, monkeypatch):
    x = images(10, seed=4)  # chunks of 4, 4 and 2
    ext = jax_extractor()
    ext.cache_dir = tmp_path
    try:
        want = ext.extract(x)
    finally:
        ext.cache_dir = None
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"feature_chunk_{i:04d}.pkl" for i in range(3)]
    port = port_extractor(cache_dir=tmp_path)
    monkeypatch.setattr(port, "_extract_chunk", _never)
    got = port.extract(x)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_chunks_written_by_port_load_in_jax(tmp_path, monkeypatch):
    x = images(10, seed=5)
    want = port_extractor(cache_dir=tmp_path).extract(x)
    with open(tmp_path / "feature_chunk_0002.pkl", "rb") as f:
        chunk = pickle.load(f)
    assert [a.shape for a in chunk] == [(2, d) for d in tf.LAYER_DIMS]
    assert all(a.dtype == np.float32 for a in chunk)
    ext = jf.ImageFeatureExtractor.__new__(jf.ImageFeatureExtractor)
    ext.chunk_size, ext.cache_dir = 4, tmp_path
    monkeypatch.setattr(ext, "_extract_chunk", _never, raising=False)
    got = ext.extract(x)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # and the port's own run of the same images agrees with JAX's compute
    assert_taps_close(want, jax_extractor().extract(x))


def test_partial_cache_resumes(tmp_path):
    x = images(10, seed=6)
    full = port_extractor(cache_dir=tmp_path).extract(x)
    (tmp_path / "feature_chunk_0001.pkl").unlink()
    again = port_extractor(cache_dir=tmp_path).extract(x)
    assert (tmp_path / "feature_chunk_0001.pkl").is_file()
    for key in full:
        np.testing.assert_array_equal(again[key], full[key])


def test_seeded_init_is_flax_like_and_repeatable():
    a = tf.ImageFeatureExtractor(seed=3, device="cpu").model.state_dict()
    b = tf.ImageFeatureExtractor(seed=3, device="cpu").model.state_dict()
    c = tf.ImageFeatureExtractor(seed=4, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    # lecun-normal: variance 1/fan_in, truncated at 2 sigma
    w = a["layer3.0.conv2.weight"]
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.05
    assert torch.equal(a["bn1.weight"], torch.ones(64))
    feats = tf.ImageFeatureExtractor(seed=3, device="cpu").extract(images(2, seed=7))
    assert all(np.isfinite(v).all() for v in feats.values())


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.ImageFeatureExtractor()


def test_audio_logmel_features_match_jax():
    labels = np.arange(12) % 10
    audio = tf.synthesize_spoken_digits(labels, seed=3)
    np.testing.assert_array_equal(audio, jf.synthesize_spoken_digits(labels, seed=3))
    got = tf.audio_logmel_features(audio, device="cpu")
    want = jf.audio_logmel_features(audio)
    assert got.shape == want.shape == (12, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_synthetic_digits_are_the_jax_packages():
    for args in ((4, 3, 32, 0), (10, 2, 16, 6)):
        a_img, a_lab = tf.synthetic_digits(*args)
        b_img, b_lab = jf.synthetic_digits(*args)
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_lab, b_lab)


def test_pair_views_match_jax_through_one_extractor():
    x, labels = tf.synthetic_digits(3, 2, 32, seed=8)
    port, jax_ext = port_extractor(), jax_extractor()
    for name, got, want in (
        ("rotate", tf.resnet_pair_views(x, labels, extractor=port),
         jf.resnet_pair_views(x, labels, extractor=jax_ext)),
        ("mnist_sound", tf.mnist_sound_pair_views(x, labels, extractor=port),
         jf.mnist_sound_pair_views(x, labels, extractor=jax_ext)),
    ):
        assert sorted(got) == sorted(want), name
        for view in want:
            assert sorted(got[view]) == sorted(want[view])
            a = np.stack([got[view][k]["data"] for k in sorted(got[view])])
            b = np.stack([want[view][k]["data"] for k in sorted(want[view])])
            assert [got[view][k]["label"] for k in sorted(got[view])] == \
                [want[view][k]["label"] for k in sorted(want[view])]
            tol = TAP_RTOL * np.abs(b).max() if view.split("-")[0] != "audio" else 1e-4
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{name} {view}")
