"""Kernel K1 (``k1_kernel``): the least time of the steps' work
(``counts/k1.py``: bytes of the real columns, centers and outputs at the
HBM rate, or FLOPs at the configuration's peak, the larger) over the
kernel's device time; one launch a training step after warm-up. None when
no launch is traced."""

import json


def read(run):
    launches = run.timeline.kernels("k1_kernel")
    if not launches:
        return None
    info = run.info
    peaks = json.loads((run.bench / "counts" / "peaks.json").read_text())
    ideal = len(launches) * run.counts("k1").ideal_seconds(
        info["batch_size"], info["dims"], info["k"], peaks[run.config["peak"]],
        peaks["hbm_bytes_per_s"])
    return 100.0 * ideal / run.timeline.seconds(launches)
