"""Model registry (PyTorch).

Same semantics as ``acav100m_tpu/models/__init__.py`` (reference
``feature_extraction/code/models/__init__.py:19-81``): models register
under an underscored name and expose ``output_dims``, ``model_tag`` and
``media_type``; ``get_model(name)`` looks them up.

The models compute in float32 or bfloat16 (``dtype``, the JAX package's
``computation.dtype``) and keep their parameters in float32 either way, as
flax keeps ``param_dtype`` float32: ``in_dtype`` applies a conv or linear
layer in its input's dtype, casting the weights at the call, as flax's
``nn.Conv(dtype=...)`` and ``nn.Dense(dtype=...)`` cast their kernels.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

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


def compute_dtype(dtype) -> torch.dtype:
    """``"float32"``, ``"bfloat16"`` (or the torch dtypes) -> torch dtype;
    raises on any other, which the port does not compute in."""
    if isinstance(dtype, torch.dtype) and dtype in DTYPES.values():
        return dtype
    if dtype is None or isinstance(dtype, str) and dtype in DTYPES:
        return DTYPES[dtype or "float32"]
    raise NotImplementedError(f"dtype {dtype}: the port computes in "
                              f"{' or '.join(DTYPES)}")


def in_dtype(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``mod`` (a Conv2d, Conv3d or Linear) applied to ``x`` in x's dtype,
    its float32 weight and bias cast to it."""
    w = mod.weight.to(x.dtype)
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    if isinstance(mod, nn.Linear):
        return F.linear(x, w, b)
    return mod._conv_forward(x, w, b)


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
