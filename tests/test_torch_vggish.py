"""Audio side of stage 4: the port's log-mel front end and ``LayerVggish``
against the JAX package, with the JAX weights carried across by
``state_dict_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.models import vggish as jv
from acav100m_tpu.ops import melspec as jmel
from acav100m_torch.models import vggish as tv
from acav100m_torch.ops import melspec as tmel

from .torch_parity import random_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(lambda: jv.LayerVggish().init(jax.random.PRNGKey(0), 32000))
    return random_variables(shapes, seed=2)


def test_vggish_examples_match():
    rng = np.random.RandomState(0)
    audio = (rng.randn(2, 32000) * 0.3).astype(np.float32)
    want = np.asarray(jmel.vggish_examples(jnp.asarray(audio)))
    got = tmel.vggish_examples(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 2, 96, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tmel.mel_matrix(), jmel.mel_matrix())
    for n in (15360, 16000, 32000, 160000):
        assert tmel.vggish_num_examples(n) == jmel.vggish_num_examples(n)
    valid = np.array([32000, 15000, 20000])
    np.testing.assert_array_equal(
        tmel.example_valid_mask(torch.from_numpy(valid), 32000).numpy(),
        np.asarray(jmel.example_valid_mask(jnp.asarray(valid), 32000)))


def test_layer_vggish_taps_match(variables):
    rng = np.random.RandomState(4)
    audio = (rng.randn(2, 32000) * 0.3).astype(np.float32)
    audio[1, 15000:] = 0.0  # a zero-padded short clip
    valid = np.array([32000, 15000], np.int32)
    model = tv.LayerVggish()
    model.load_state_dict(tv.state_dict_from_flax(variables))
    jm = jv.LayerVggish()
    for vs in (None, valid):
        want = jm.apply(variables, jnp.asarray(audio),
                        None if vs is None else jnp.asarray(vs))
        with torch.inference_mode():
            got = model(torch.from_numpy(audio), None if vs is None else torch.from_numpy(vs))
        assert [g.shape[-1] for g in got] == tv.LAYER_DIMS
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


def test_state_dict_names_are_torchvggish(variables):
    sd = tv.state_dict_from_flax(variables)
    assert set(sd) == set(tv.LayerVggish().state_dict())
    assert "features.13.weight" in sd and "embeddings.4.bias" in sd
    back = jv.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    for name, leaves in variables["params"].items():
        for leaf, val in leaves.items():
            np.testing.assert_array_equal(back["params"][name][leaf], val)


def test_vggish_embedding_only_variant(variables):
    rng = np.random.RandomState(1)
    audio = torch.from_numpy((rng.randn(1, 16000) * 0.3).astype(np.float32))
    layer, emb = tv.LayerVggish(), tv.Vggish()
    sd = tv.state_dict_from_flax(variables)
    layer.load_state_dict(sd)
    emb.load_state_dict(sd)
    with torch.inference_mode():
        np.testing.assert_array_equal(emb(audio).numpy(), layer(audio)[-1].numpy())
