"""Plain SlowFast 8x8 R50 with non-local blocks, SLOWFAST_NLN_8x8_R50, with
the five layer taps: the tests' reference for ``layer_slowfast_nln``.

PySlowFast's ``configs/Kinetics/SLOWFAST_NLN_8x8_R50.yaml``: SLOWFAST_8x8_R50
(slow pathway on every 4th frame, channels 64/256/512/1024/2048, temporal
kernels 1,1,1,3,3; fast pathway on every frame, 8/32/64/128/256, 5,3,3,3,3;
a 7x1x1 fast-to-slow fusion after s1..s4; bottleneck blocks [3,4,6,3];
spatial strides [1,2,2,2]; inference batch norm) with non-local blocks
(``slowfast/models/nonlocal_helper.py``, ``Nonlocal``) on the slow pathway
after blocks 1 and 3 of ``res3`` and 1, 3 and 5 of ``res4`` (0-indexed;
``NONLOCAL.LOCATION [[[], []], [[1, 3], []], [[1, 3, 5], []], [[], []]]``,
``GROUP`` 1, ``POOL [1, 2, 2]``), placed and named as ``ResStage``
(``slowfast/models/resnet_helper.py``) places and names them. A block:

    theta = conv_theta(x); phi, g = conv_phi(p), conv_g(p), p = maxpool(x)
    theta_phi = einsum("nct,ncp->ntp", theta, phi)
    dot_product: theta_phi / Nk; softmax: softmax(theta_phi * C'^-1/2, keys)
    y = einsum("ntg,ncg->nct", theta_phi, g); out = x + bn(conv_out(y))

in the published order (S materialised). The taps are the global means over
(T,H,W) after s1_fuse, s2_fuse, s3_fuse, s4_fuse and s5, the pathways
concatenated: 88, 352, 704, 1408, 2304. Float32, plain ``torch.nn``, TF32
off for the forward; it imports nothing of either package and no kernel.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

ALPHA, BETA_INV, FUSION_RATIO, FUSION_KERNEL = 4, 8, 2, 7
STAGE_BLOCKS = [3, 4, 6, 3]
SLOW_KT = [1, 1, 1, 3, 3]
FAST_KT = [5, 3, 3, 3, 3]
STRIDES = [1, 2, 2, 2]
MEAN, STD = 0.45, 0.225
NLN_LOCATION = ((), (1, 3), (1, 3, 5), ())
NLN_POOL = (1, 2, 2)


def _bn(c):
    return nn.BatchNorm3d(c, eps=1e-5)


class Stem(nn.Module):
    def __init__(self, cin, cout, kt):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, (kt, 7, 7), (1, 2, 2), (kt // 2, 3, 3), bias=False)
        self.bn = _bn(cout)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv(x)))
        return nn.functional.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class StemPair(nn.Module):
    def __init__(self):
        super().__init__()
        self.pathway0_stem = Stem(3, 64, SLOW_KT[0])
        self.pathway1_stem = Stem(3, 64 // BETA_INV, FAST_KT[0])


class Fuse(nn.Module):
    def __init__(self, cf):
        super().__init__()
        self.conv_f2s = nn.Conv3d(cf, cf * FUSION_RATIO, (FUSION_KERNEL, 1, 1), (ALPHA, 1, 1),
                                  (FUSION_KERNEL // 2, 0, 0), bias=False)
        self.bn = _bn(cf * FUSION_RATIO)

    def forward(self, slow, fast):
        return torch.cat([slow, torch.relu(self.bn(self.conv_f2s(fast)))], 1)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, inner, kt, stride):
        super().__init__()
        self.a = nn.Conv3d(cin, inner, (kt, 1, 1), padding=(kt // 2, 0, 0), bias=False)
        self.a_bn = _bn(inner)
        self.b = nn.Conv3d(inner, inner, (1, 3, 3), (1, stride, stride), (0, 1, 1), bias=False)
        self.b_bn = _bn(inner)
        self.c = nn.Conv3d(inner, cout, 1, bias=False)
        self.c_bn = _bn(cout)

    def forward(self, x):
        x = torch.relu(self.a_bn(self.a(x)))
        x = torch.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class Block(nn.Module):
    def __init__(self, cin, cout, inner, kt, stride):
        super().__init__()
        if cin != cout or stride != 1:
            self.branch1 = nn.Conv3d(cin, cout, 1, (1, stride, stride), bias=False)
            self.branch1_bn = _bn(cout)
        self.branch2 = Bottleneck(cin, cout, inner, kt, stride)

    def forward(self, x):
        short = self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1") else x
        return torch.relu(short + self.branch2(x))


class Nonlocal(nn.Module):
    """PySlowFast's ``Nonlocal``, its forward as written there."""

    def __init__(self, dim, dim_inner, pool, instantiation):
        super().__init__()
        self.dim_inner, self.instantiation = dim_inner, instantiation
        self.conv_theta = nn.Conv3d(dim, dim_inner, 1)
        self.conv_phi = nn.Conv3d(dim, dim_inner, 1)
        self.conv_g = nn.Conv3d(dim, dim_inner, 1)
        self.conv_out = nn.Conv3d(dim_inner, dim, 1)
        self.bn = _bn(dim)
        self.pool = nn.MaxPool3d(pool, pool, (0, 0, 0))

    def forward(self, x):
        n, _, t, h, w = x.shape
        theta = self.conv_theta(x)
        p = self.pool(x)
        phi, g = self.conv_phi(p), self.conv_g(p)
        theta, phi, g = (v.view(n, self.dim_inner, -1) for v in (theta, phi, g))
        theta_phi = torch.einsum("nct,ncp->ntp", (theta, phi))
        if self.instantiation == "softmax":
            theta_phi = torch.softmax(theta_phi * self.dim_inner ** -0.5, dim=2)
        elif self.instantiation == "dot_product":
            theta_phi = theta_phi / theta_phi.shape[2]
        else:
            raise NotImplementedError(self.instantiation)
        y = torch.einsum("ntg,ncg->nct", (theta_phi, g)).view(n, self.dim_inner, t, h, w)
        return x + self.bn(self.conv_out(y))


class Stage(nn.Module):
    def __init__(self, si, cin_slow, cin_fast, nonlocal_idx, instantiation):
        super().__init__()
        cout, inner = 256 * 2 ** si, 64 * 2 ** si
        self.n = STAGE_BLOCKS[si]
        for p, (cin, co, inn, kt) in enumerate((
                (cin_slow, cout, inner, SLOW_KT[si + 1]),
                (cin_fast, cout // BETA_INV, inner // BETA_INV, FAST_KT[si + 1]))):
            for i in range(self.n):
                self.add_module(f"pathway{p}_res{i}",
                                Block(cin if i == 0 else co, co, inn, kt,
                                      STRIDES[si] if i == 0 else 1))
                if p == 0 and i in nonlocal_idx:
                    self.add_module(f"pathway0_nonlocal{i}",
                                    Nonlocal(co, co // 2, NLN_POOL, instantiation))

    def forward(self, slow, fast):
        for i in range(self.n):
            slow = getattr(self, f"pathway0_res{i}")(slow)
            if hasattr(self, f"pathway0_nonlocal{i}"):
                slow = getattr(self, f"pathway0_nonlocal{i}")(slow)
            fast = getattr(self, f"pathway1_res{i}")(fast)
        return slow, fast


class SlowFastNlnTaps(nn.Module):
    """uint8 frames (B, T, H, W, 3) -> the five taps (B, dim), float32.
    ``nonlocal_location``: slow-pathway block indices of s2..s5 (an empty
    list a stage takes the blocks out)."""

    def __init__(self, nonlocal_location: Sequence[Sequence[int]] = NLN_LOCATION,
                 instantiation: str = "dot_product"):
        super().__init__()
        self.s1 = StemPair()
        self.s1_fuse = Fuse(64 // BETA_INV)
        cin_slow, cin_fast = 64 + 2 * 64 // BETA_INV, 64 // BETA_INV
        for si in range(4):
            self.add_module(f"s{si + 2}", Stage(si, cin_slow, cin_fast,
                                                tuple(nonlocal_location[si]), instantiation))
            cout = 256 * 2 ** si
            if si < 3:
                self.add_module(f"s{si + 2}_fuse", Fuse(cout // BETA_INV))
                cin_slow = cout + 2 * cout // BETA_INV
            else:
                cin_slow = cout
            cin_fast = cout // BETA_INV
        self.eval()

    @staticmethod
    def _pool(slow, fast):
        return torch.cat([slow.mean((2, 3, 4)), fast.mean((2, 3, 4))], -1)

    def forward(self, frames: torch.Tensor) -> List[torch.Tensor]:
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            x = (frames.float() / 255.0 - MEAN) / STD  # (B, T, H, W, C)
            x = x.permute(0, 4, 1, 2, 3)  # NCDHW
            slow, fast = x[:, :, ::ALPHA].contiguous(), x.contiguous()
            slow = self.s1.pathway0_stem(slow)
            fast = self.s1.pathway1_stem(fast)
            slow = self.s1_fuse(slow, fast)
            taps = [self._pool(slow, fast)]
            for si in range(4):
                slow, fast = getattr(self, f"s{si + 2}")(slow, fast)
                if si < 3:
                    slow = getattr(self, f"s{si + 2}_fuse")(slow, fast)
                taps.append(self._pool(slow, fast))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return taps


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
