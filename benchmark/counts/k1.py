"""Work of kernel K1, one k-means assign + accumulate step, from its shapes.

``rows`` feature rows of each of the clusterings of real widths ``dims``
against ``k`` centers each: distances (one multiply-add a row, center and
column) and per-center sums of the assigned rows (one add a row and
column). Bytes: the rows' real columns read once, the centers and their
counts read once, the sums, counts and assignments written once (float32;
the zero padding past each width is not counted).
"""


def flops(rows: int, dims, k: int) -> float:
    d = sum(dims)
    return 2.0 * rows * k * d + rows * d


def bytes_moved(rows: int, dims, k: int) -> float:
    d, m = sum(dims), len(dims)
    return 4.0 * (rows * d + 2 * k * d + 2 * k * m + rows * m)


def ideal_seconds(rows: int, dims, k: int, peak_flops: float, peak_bytes: float) -> float:
    return max(flops(rows, dims, k) / peak_flops, bytes_moved(rows, dims, k) / peak_bytes)
