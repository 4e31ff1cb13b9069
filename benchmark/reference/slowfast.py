"""Plain SlowFast 8x8 R50 with layer taps: the benchmark's frozen reference.

PySlowFast's ``SLOWFAST_8x8_R50`` (Kinetics-400) as ACAV100M taps it
(``feature_extraction/code/models/slowfast.py``): slow pathway on every
4th frame (channels 64/256/512/1024/2048, temporal kernels 1,1,1,3,3),
fast pathway on every frame (8/32/64/128/256; 5,3,3,3,3), a 7x1x1
fast-to-slow fusion after s1..s4, bottleneck blocks [3,4,6,3], spatial
strides [1,2,2,2], inference batch norm. The five taps are the global
means over (T,H,W) after s1_fuse, s2_fuse, s3_fuse, s4_fuse and s5, the
pathways concatenated: 88, 352, 704, 1408, 2304.

Plain ``torch.nn`` modules named as PySlowFast names them, in float32,
every stage on the same canonical graph (no fused stage, no folded batch
norm). It imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

ALPHA, BETA_INV, FUSION_RATIO, FUSION_KERNEL = 4, 8, 2, 7
STAGE_BLOCKS = [3, 4, 6, 3]
SLOW_KT = [1, 1, 1, 3, 3]
FAST_KT = [5, 3, 3, 3, 3]
STRIDES = [1, 2, 2, 2]
MEAN, STD = 0.45, 0.225
TAP_DIMS = [88, 352, 704, 1408, 2304]


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


class Stage(nn.Module):
    def __init__(self, si, cin_slow, cin_fast):
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

    def forward(self, slow, fast):
        for i in range(self.n):
            slow = getattr(self, f"pathway0_res{i}")(slow)
            fast = getattr(self, f"pathway1_res{i}")(fast)
        return slow, fast


class SlowFastTaps(nn.Module):
    """uint8 frames (B, T, H, W, 3) -> the five taps (B, dim), float32."""

    def __init__(self):
        super().__init__()
        self.s1 = StemPair()
        self.s1_fuse = Fuse(64 // BETA_INV)
        cin_slow, cin_fast = 64 + 2 * 64 // BETA_INV, 64 // BETA_INV
        for si in range(4):
            self.add_module(f"s{si + 2}", Stage(si, cin_slow, cin_fast))
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
        return taps
