"""The non-local models' FLOPs per clip (``counts/nonlocal.py``: SLOWFAST_NLN_8x8_R50
over the plain reference with each non-local core in its cheaper order, plus
VGGish) times the clips the traced window completed, over the window and the
configuration's peak (``counts/peaks.json``)."""

import json


def read(run):
    if not run.timeline.kernels():
        return None
    info = run.info
    per_clip = run.counts("nonlocal").per_clip(info["num_frames"], info["size"],
                                               info["audio_seconds"])
    peaks = json.loads((run.bench / "counts" / "peaks.json").read_text())
    return 100.0 * per_clip * run.units / run.window_s / peaks[run.config["peak"]]
