"""Share of the traced window in which the device ran nothing: one minus
the union of kernel, copy and set intervals over the window."""


def read(run):
    return run.timeline.idle_pct()
