"""Model registry (PyTorch).

Same semantics as ``acav100m_tpu/models/__init__.py`` (reference
``feature_extraction/code/models/__init__.py:19-81``): models register
under an underscored name and expose ``output_dims``, ``model_tag`` and
``media_type``; ``get_model(name)`` looks them up.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

_REGISTRY: Dict[str, type] = {}


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.model_name = name
        return cls

    return deco


def _load_all():
    from . import slowfast as _slowfast  # noqa: F401
    from . import vggish as _vggish  # noqa: F401


def get_model(name: str):
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def model_names():
    _load_all()
    return sorted(_REGISTRY)


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, 1) truncated to [-2, 2] by redrawing the outliers, times std."""
    flat = t.view(-1).normal_(0.0, 1.0, generator=generator)
    idx = torch.nonzero(flat.abs() > 2).squeeze(1)
    while idx.numel():
        vals = torch.randn(idx.numel(), generator=generator, dtype=t.dtype)
        flat[idx] = vals
        idx = idx[vals.abs() > 2]
    t.mul_(std)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with flax's defaults: lecun-normal kernels (normal
    truncated at 2 sigma, variance 1/fan_in), zero biases."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            _trunc_normal_(mod.weight, (1.0 / fan_in) ** 0.5 / 0.87962566103423978,
                           generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
