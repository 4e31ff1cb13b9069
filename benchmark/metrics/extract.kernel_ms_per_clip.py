"""Device kernel time (copies left out) of the traced window per clip
completed."""


def read(run):
    kernels = run.timeline.kernels()
    if not kernels or not run.units:
        return None
    return 1e3 * run.timeline.seconds(kernels) / run.units
