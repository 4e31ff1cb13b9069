"""Work of kernel K2: the SlowFast ``s2`` slow stage, from its shapes.

Three bottleneck blocks on frames of ``hw`` x ``hw`` (stride 1): block 0
takes ``cin`` channels with a projection shortcut, blocks 1-2 take
``cout``; each has a 1x1 (``a``, to ``inner``), a 3x3 (``b``) and a 1x1
(``c``, to ``cout``). The count is the stage's own multiply-adds, whatever
a kernel issues to compute them (3xTF32 issues each product three times).
Bytes: the input read once, the output and the weights written and read
once, intermediates not counted.
"""

CIN, INNER, COUT, BLOCKS = 80, 64, 256, 3


def macs_per_pixel(cin=CIN, inner=INNER, cout=COUT, blocks=BLOCKS) -> int:
    first = cin * inner + 9 * inner * inner + inner * cout + cin * cout
    rest = cout * inner + 9 * inner * inner + inner * cout
    return first + (blocks - 1) * rest


def weight_elements(cin=CIN, inner=INNER, cout=COUT, blocks=BLOCKS) -> int:
    return macs_per_pixel(cin, inner, cout, blocks) + 2 * inner * blocks + cout * (blocks + 1)


def flops(frames: int, hw: int) -> float:
    return 2.0 * frames * hw * hw * macs_per_pixel()


def bytes_moved(frames: int, hw: int, itemsize: int) -> float:
    return float(frames * hw * hw * (CIN + COUT) * itemsize + weight_elements() * itemsize)


def ideal_seconds(frames: int, hw: int, itemsize: int, peak_flops: float,
                  peak_bytes: float) -> float:
    """The stage's least time on the card: the larger of its two bounds."""
    return max(flops(frames, hw) / peak_flops, bytes_moved(frames, hw, itemsize) / peak_bytes)
