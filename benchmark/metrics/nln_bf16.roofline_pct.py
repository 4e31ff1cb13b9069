"""The non-local core's kernel (``nonlocal_core_bf16_kernel``): the least time
of the window's batches' cores (``counts/nonlocal.py``: each block at the
larger of its operations in the cheaper order at the bf16 peak and theta,
phi, g and y once at the HBM rate; 0.35 ms a batch of 32 at the published
shapes) over the kernel's device time. Batches are the program's
``extract.batches`` counter, whatever the kernel's launches a batch. None when
no launch of the kernel is traced (a renamed kernel) or the program counts no
batch."""

import json


def read(run):
    launches = run.timeline.kernels("nonlocal_core_bf16_kernel")
    if not launches:
        return None
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    batches = tracing.counters().get("extract.batches")
    if not batches:
        return None
    info = run.info
    peaks = json.loads((run.bench / "counts" / "peaks.json").read_text())
    ideal = batches * run.counts("nonlocal").ideal_seconds(
        info["batch_size"], info["num_frames"], info["size"], 2, peaks["bf16"],
        peaks["hbm_bytes_per_s"])
    return 100.0 * ideal / run.timeline.seconds(launches)
