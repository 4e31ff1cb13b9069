"""Device kernel time (copies left out) of the traced window per clip
picked."""


def read(run):
    kernels = run.timeline.kernels()
    picks = run.info["picks"]
    if not kernels or not picks:
        return None
    return 1e3 * run.timeline.seconds(kernels) / picks
