"""Per-layer-pair weights for weighted MI.

A copy of ``acav100m_tpu/retrieval/pair_weights.py`` (the port imports nothing of
the JAX package).

Port of ``correspondence_retrieval/code/pair_weights.py:4-47``: each layer
gets a weight from a linear/log/exp ramp (or a one-hot pick), the two views'
layer weights are mirrored, and a pair's weight is the product of its two
member weights.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _layer_weights(n_layer: int, weight_type: str) -> np.ndarray:
    parts = weight_type.split("_")
    func_name = parts[0]
    if func_name == "onehot":
        weights = np.zeros(n_layer)
        idx = int(parts[1]) if len(parts) == 2 else 0
        weights[idx] = 1.0
        return weights
    coeff = float(parts[1]) if len(parts) == 2 else 1.0
    func = {
        "linear": lambda x: x,
        "log": np.log,
        "exp": np.exp,
    }[func_name]
    mean = (1 + n_layer) / 2
    x = np.arange(float(n_layer)) - mean
    weights = x * coeff + 1
    weights = weights - weights.min() + 2  # log stabilization
    weights = func(weights)
    return weights / np.median(weights)


def get_weights(pairing: Sequence[Tuple[int, int]],
                weight_type: Optional[str] = None):
    """pairing + weight_type -> per-pair weights (or None).

    Assumes the clustering index space is two mirrored views of n_layer
    layers each (reference pair_weights.py:9-13).
    """
    if weight_type is None:
        return None
    n_layer = (int(np.array(list(pairing)).max()) + 1) // 2
    lw = _layer_weights(n_layer, weight_type)
    lw = np.concatenate([lw, lw])
    # f64 like the reference (host-side scalars; device scorers cast)
    return np.array([lw[a] * lw[b] for a, b in pairing], dtype=np.float64)
