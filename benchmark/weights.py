"""Seeded weights for a model, made on the device in a few large draws.

The plain reference defines the names and shapes (built on the meta
device); the same tensors are loaded into the program's model and the
reference's, so both sides take one set of weights. Conv and linear
weights are normal with variance 1/fan_in (lecun), biases small normal;
batch norm is randomised so that folding it is exercised: scale in
[0.8, 1.2] ([0.1, 0.3] on each block's last norm, which keeps the
residual sums of a 16-block network in range), shift, running mean small
normal, running variance in [0.8, 1.2].
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch
from torch import nn


def make_state_dict(model: nn.Module, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    gen = torch.Generator(device=device).manual_seed(seed)
    normal, uniform = [], []  # (name, shape, scale, offset)
    ints: Dict[str, torch.Size] = {}
    bn_last = set()
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm3d) and mod_name.endswith("c_bn"):
            bn_last.add(mod_name)
    for name, t in model.state_dict(keep_vars=True).items():
        mod_name, leaf = name.rsplit(".", 1)
        shape = t.shape
        if t.dtype == torch.long:
            ints[name] = shape
        elif leaf == "weight" and t.dim() > 1:
            normal.append((name, shape, (1.0 / t[0].numel()) ** 0.5, 0.0))
        elif leaf == "weight":  # a norm's scale
            lo, hi = (0.1, 0.3) if mod_name in bn_last else (0.8, 1.2)
            uniform.append((name, shape, hi - lo, lo))
        elif leaf == "running_var":
            uniform.append((name, shape, 0.4, 0.8))
        else:  # biases, shifts, running means
            normal.append((name, shape, 0.05, 0.0))
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for entries, draw in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [int(torch.Size(s).numel()) for _, s, _, _ in entries]
        flat = draw(sum(sizes), generator=gen, device=device)
        for (name, shape, scale, offset), part in zip(entries, flat.split(sizes)):
            out[name] = part.view(shape).mul_(scale).add_(offset)
    for name, shape in ints.items():
        out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return OrderedDict((k, out[k]) for k in model.state_dict())


def reference_on_meta(cls) -> nn.Module:
    with torch.device("meta"):
        return cls()


def load_into(model: nn.Module, state: Dict[str, torch.Tensor], device) -> nn.Module:
    """``model`` (built on the meta device) materialised on ``device`` with
    ``state``; buffers outside the state dict (the int8 observers' maxima)
    start at zero, as the program's constructors make them."""
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    keys = set(state)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name not in keys:
                buf.zero_()
    return model.eval()
