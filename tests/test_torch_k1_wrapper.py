"""What kernel K1's wrapper decides on the host, checked on the CPU: the
``dims`` argument against the JAX Pallas kernel on zero-padded inputs, the
``dims`` it refuses, ``train_step`` passing the widths of ``d_mask``, and
the ablation variants of the kernel source. The kernel itself runs only on
the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acav100m_tpu.ops.pallas import kmeans_kernel as jkk
from acav100m_torch import ablate_k1, tracing
from acav100m_torch.ops import kmeans as tk
from acav100m_torch.ops import kmeans_kernel as tkk

torch.set_num_threads(1)


def _padded_inputs(dims, k, b, seed):
    """Rows and centers zero past each clustering's width; about half the
    centers underused at the returned threshold."""
    rng = np.random.RandomState(seed)
    m, d = len(dims), max(dims)
    mask = (np.arange(d)[None, :] < np.array(dims)[:, None]).astype(np.float32)
    batch = rng.randn(m, b, d).astype(np.float32) * mask[:, None, :]
    centers = rng.randn(m, k, d).astype(np.float32) * mask[:, None, :]
    counts = rng.randint(0, 400, (m, k)).astype(np.float32)
    threshold = float(jnp.maximum(jnp.float32(10000) / k, 0.0) ** 0.7)
    return centers, counts, batch, threshold


@pytest.mark.parametrize("dims,k,b", [
    ((48, 30, 20), 8, 64),
    ((40, 40, 8, 13), 4, 100),   # one clustering at full width, a ragged one
    ((88, 64, 128, 24), 32, 40),  # the main path's K
])
def test_dims_matches_pallas_on_padded_input(dims, k, b):
    centers, counts, batch, threshold = _padded_inputs(dims, k, b, seed=sum(dims) + b)
    jb, jc, jd, jm = jkk.fused_assign_update(
        jnp.asarray(centers), jnp.asarray(counts), jnp.asarray(batch),
        jnp.float32(threshold), tile_b=64, interpret=True)
    with tracing.enabled():
        tb, tc, td, tm = tkk.fused_assign_update(
            torch.from_numpy(centers), torch.from_numpy(counts), torch.from_numpy(batch),
            threshold, dims=dims)
        assert tracing.counters() == {}  # CPU tensors: plain version
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # different summation orders: 1e-5 relative on sums of O(10) values
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    for i, d in enumerate(dims):
        assert not td[i, :, d:].any()


@pytest.mark.parametrize("dims", [
    (48, 30),          # one width short
    (48, 30, 20, 4),   # one too many
    (48, 0, 20),       # an empty clustering
    (48, 49, 20),      # wider than the padded width
    (48, 30.5, 20),    # not an int
    "abc",
])
def test_wrapper_refuses_bad_dims(dims):
    centers, counts, batch, threshold = _padded_inputs((48, 30, 20), 4, 8, seed=0)
    with pytest.raises(ValueError, match="dims"):
        tkk.fused_assign_update(torch.from_numpy(centers), torch.from_numpy(counts),
                                torch.from_numpy(batch), threshold, dims=dims)


def test_wrapper_takes_numpy_ints_as_dims():
    centers, counts, batch, threshold = _padded_inputs((48, 30, 20), 4, 8, seed=1)
    out = tkk.fused_assign_update(torch.from_numpy(centers), torch.from_numpy(counts),
                                  torch.from_numpy(batch), threshold,
                                  dims=np.array([48, 30, 20]))
    ref = tkk.fused_assign_update_ref(torch.from_numpy(centers), torch.from_numpy(counts),
                                      torch.from_numpy(batch), threshold)
    for u, v in zip(out, ref):
        assert torch.equal(u, v)


@pytest.mark.parametrize("d_mask,want", [
    ([[1, 1, 0], [1, 1, 1]], (2, 3)),
    ([[1, 0, 1], [1, 1, 1]], None),  # not a prefix
    ([[0, 0, 0], [1, 1, 1]], None),  # an empty row
])
def test_mask_dims(d_mask, want):
    assert tk.mask_dims(np.array(d_mask, np.float32)) == want


def test_state_carries_dims_through_init_step_and_checkpoint():
    state = tk.init_state([48, 30, 20], 4, generator=torch.Generator().manual_seed(0))
    assert state.dims == (48, 30, 20)
    batch = torch.zeros((3, 8, 48))
    state, _ = tk.train_step(state, batch, 0.1, generator=torch.Generator().manual_seed(1))
    assert state.dims == (48, 30, 20)
    assert tk.load_attrs(tk.get_attrs(state)).dims == (48, 30, 20)


def test_train_step_passes_dims_and_matches_a_run_without_them(monkeypatch):
    """The same states over post-warmup steps whether K1 is told the widths
    or not, and the widths it is told are those of d_mask."""
    dims, k, b, lr = [48, 30, 20], 4, 16, 0.05
    rng = np.random.RandomState(11)
    m, dmax = len(dims), max(dims)
    mask = (np.arange(dmax)[None, :] < np.array(dims)[:, None]).astype(np.float32)
    protos = rng.randn(m, 5, dmax).astype(np.float32) * 3
    batches = []
    for _ in range(6):
        lab = rng.randint(0, 5, (m, b))
        x = protos[np.arange(m)[:, None], lab] + rng.randn(m, b, dmax).astype(np.float32)
        batches.append(torch.from_numpy(x * mask[:, None, :]))
    seen = []
    real = tkk.fused_assign_update

    def spy(*args, dims=None):
        seen.append(dims)
        return real(*args, dims=dims)

    def blind(*args, dims=None):
        return real(*args)

    states = []
    for fn in (spy, blind):
        monkeypatch.setattr(tk, "fused_assign_update", fn)
        state = tk.init_state(dims, k, generator=torch.Generator().manual_seed(3))
        state.count = 10 * k  # past warmup: every step goes through K1
        for x in batches:
            state, mean = tk.train_step(state, x, lr)
        states.append((state, mean))
    assert seen == [tuple(dims)] * len(batches)
    (s1, m1), (s2, m2) = states
    for u, v in ((s1.centers, s2.centers), (s1.counts, s2.counts), (m1, m2)):
        assert torch.equal(u, v)
    assert s1.count == s2.count and int(s1.fallback) == int(s2.fallback)


@pytest.mark.parametrize("name", sorted(ablate_k1.VARIANTS))
def test_ablation_variant_applies_to_the_kernel_source(name):
    src = ablate_k1.variant_source(ablate_k1.VARIANTS[name])
    assert (src == ablate_k1.SRC.read_text()) == (name == "full")
    assert 'extern "C" int kmeans_assign_update(' in src


def test_k1_inputs_are_zero_past_the_widths():
    gen = torch.Generator().manual_seed(0)
    dims = (12, 8, 4)
    centers, counts, batch, threshold = ablate_k1.k1_inputs(gen, 4, 16, dims, seen=48,
                                                            device="cpu")
    assert centers.shape == (3, 4, 12) and batch.shape == (3, 16, 12)
    for i, d in enumerate(dims):
        assert not batch[i, :, d:].any() and not centers[i, :, d:].any()
        assert batch[i, :, :d].abs().min() > 0
    assert 0 < int((counts < threshold).sum()) < counts.numel()
