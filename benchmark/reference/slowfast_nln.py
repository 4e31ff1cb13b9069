"""Plain SlowFast 8x8 R50 with non-local blocks, SLOWFAST_NLN_8x8_R50, with
layer taps: the benchmark's frozen reference for ``layer_slowfast_nln``.

``reference/slowfast.py``'s SlowFast 8x8 R50 with PySlowFast's non-local
blocks (``slowfast/models/nonlocal_helper.py``, ``Nonlocal``) on the slow
pathway after blocks 1 and 3 of ``res3`` and 1, 3 and 5 of ``res4``
(``configs/Kinetics/SLOWFAST_NLN_8x8_R50.yaml``: ``NONLOCAL.LOCATION
[[[], []], [[1, 3], []], [[1, 3, 5], []], [[], []]]``, ``GROUP`` 1, ``POOL
[1, 2, 2]``, ``INSTANTIATION dot_product``), named as PySlowFast's
``ResStage`` names them (``s3.pathway0_nonlocal1.conv_theta.weight``, ...).
A block, in the published order (S materialised):

    theta = conv_theta(x); phi, g = conv_phi(p), conv_g(p), p = maxpool(x)
    theta_phi = einsum("nct,ncp->ntp", theta, phi) / Nk
    y = einsum("ntg,ncg->nct", theta_phi, g); out = x + bn(conv_out(y))

Float32, plain ``torch.nn``, TF32 off for the forward; it imports nothing of
the program. ``nonlocal_location`` with empty lists takes the blocks out (the
same weights without them).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from benchmark.reference import slowfast as sf

NLN_LOCATION = ((), (1, 3), (1, 3, 5), ())
NLN_POOL = (1, 2, 2)


class Nonlocal(nn.Module):
    """PySlowFast's ``Nonlocal`` (``dot_product``), its forward as written
    there."""

    def __init__(self, dim, dim_inner):
        super().__init__()
        self.dim_inner = dim_inner
        self.conv_theta = nn.Conv3d(dim, dim_inner, 1)
        self.conv_phi = nn.Conv3d(dim, dim_inner, 1)
        self.conv_g = nn.Conv3d(dim, dim_inner, 1)
        self.conv_out = nn.Conv3d(dim_inner, dim, 1)
        self.bn = sf._bn(dim)
        self.pool = nn.MaxPool3d(NLN_POOL, NLN_POOL, (0, 0, 0))

    def forward(self, x):
        n, _, t, h, w = x.shape
        theta = self.conv_theta(x)
        p = self.pool(x)
        phi, g = self.conv_phi(p), self.conv_g(p)
        theta, phi, g = (v.reshape(n, self.dim_inner, -1) for v in (theta, phi, g))
        theta_phi = torch.einsum("nct,ncp->ntp", (theta, phi))
        theta_phi = theta_phi / theta_phi.shape[2]
        y = torch.einsum("ntg,ncg->nct", (theta_phi, g)).reshape(n, self.dim_inner, t, h, w)
        return x + self.bn(self.conv_out(y))


class Stage(sf.Stage):
    def __init__(self, si, cin_slow, cin_fast, nonlocal_idx):
        super().__init__(si, cin_slow, cin_fast)
        cout = 256 * 2 ** si
        for i in nonlocal_idx:
            self.add_module(f"pathway0_nonlocal{i}", Nonlocal(cout, cout // 2))

    def forward(self, slow, fast):
        for i in range(self.n):
            slow = getattr(self, f"pathway0_res{i}")(slow)
            if hasattr(self, f"pathway0_nonlocal{i}"):
                slow = getattr(self, f"pathway0_nonlocal{i}")(slow)
            fast = getattr(self, f"pathway1_res{i}")(fast)
        return slow, fast


class SlowFastNlnTaps(sf.SlowFastTaps):
    """uint8 frames (B, T, H, W, 3) -> the five taps (B, dim), float32."""

    def __init__(self, nonlocal_location: Sequence[Sequence[int]] = NLN_LOCATION):
        super().__init__()
        cin_slow, cin_fast = 64 + 2 * 64 // sf.BETA_INV, 64 // sf.BETA_INV
        for si in range(4):
            setattr(self, f"s{si + 2}", Stage(si, cin_slow, cin_fast, nonlocal_location[si]))
            cout = 256 * 2 ** si
            cin_slow = cout + 2 * cout // sf.BETA_INV if si < 3 else cout
            cin_fast = cout // sf.BETA_INV
        self.eval()

    def forward(self, frames: torch.Tensor) -> List[torch.Tensor]:
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return super().forward(frames)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@torch.no_grad()
def calibrate_nonlocal(model: nn.Module, frames: torch.Tensor) -> None:
    """Set each non-local block's data-dependent weights over ``frames``,
    block after block in the forward's order: the biases of ``conv_theta``,
    ``conv_phi`` and ``conv_g`` take away their outputs' means, and the BN
    statistics become those of its input, as PySlowFast's precise BN
    (``BN.USE_PRECISE_STATS``) computes a population's. On random weights
    the blocks' inputs follow a ReLU, so uncentred phi and g make
    ``g phi^T / Nk`` all but one outer product of their means: every channel
    of the block's output is then one signal at another scale, and the BN
    blows up the rounding of the channels with little of it. Random
    statistics, not their inputs', let five blocks overflow float32."""
    def center(mod, args):
        x = args[0]
        p = mod.pool(x)
        for conv, inp in ((mod.conv_theta, x), (mod.conv_phi, p), (mod.conv_g, p)):
            conv.bias.sub_(conv(inp).mean((0, 2, 3, 4)))

    def stats(bn, args):
        z = args[0].float()
        bn.running_mean.copy_(z.mean((0, 2, 3, 4)))
        bn.running_var.copy_(z.var((0, 2, 3, 4), unbiased=False))

    blocks = [m for m in model.modules() if isinstance(m, Nonlocal)]
    handles = [m.register_forward_pre_hook(center) for m in blocks]
    handles += [m.bn.register_forward_pre_hook(stats) for m in blocks]
    try:
        model(frames)
    finally:
        for h in handles:
            h.remove()
