"""Kernel K2 (bf16 form, ``bottleneck_block_bf16_kernel``): the least time of the stage's
work (``counts/k2.py``, the larger of its FLOPs at the bf16 peak and its
bytes at the HBM rate) over the kernel's device time. Three launches (one a
block) make one stage of one batch. Counted from the mathematics, this
share reads a third of one counted from the products 3xTF32 issues.
None when no launch of the kernel is traced (a renamed kernel)."""

import json


def read(run):
    launches = run.timeline.kernels("bottleneck_block_bf16_kernel")
    if not launches:
        return None
    info = run.info
    peaks = json.loads((run.bench / "counts" / "peaks.json").read_text())
    k2 = run.counts("k2")
    stages = len(launches) / 3
    ideal = stages * k2.ideal_seconds(info["batch_size"] * info["slow_frames"], info["k2_hw"],
                                      2, peaks["bf16"], peaks["hbm_bytes_per_s"])
    return 100.0 * ideal / run.timeline.seconds(launches)
