"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``):
seeded random flax variable trees, so both packages run identical weights
with randomized batch-norm statistics and non-zero gammas."""

import numpy as np


def random_variables(shapes, seed=0):
    """Fill a tree of ShapeDtypeStructs (``jax.eval_shape`` of an init)
    with seeded values: kernels ~ N(0, 1/fan_in), BN scale and var in
    [0.5, 1.5], biases and means ~ N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)

    def fill(node, name=""):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: fill(v, k) for k, v in node.items()}
        shape = tuple(node.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.randn(*shape) * 0.1
        return v.astype(np.float32)

    return fill(shapes)
