"""Stage 5's k-means FLOPs in the traced window (``counts/k1.py`` for each
training step and each assignment batch) over the window and the
configuration's peak."""

import json


def read(run):
    if not run.timeline.kernels():
        return None
    info = run.info
    k1 = run.counts("k1")
    work = (info["train_steps"] * k1.flops(info["batch_size"], info["dims"], info["k"])
            + info["assign_rows"] * 2.0 * info["k"] * sum(info["dims"]))
    peaks = json.loads((run.bench / "counts" / "peaks.json").read_text())
    return 100.0 * work / run.window_s / peaks[run.config["peak"]]
