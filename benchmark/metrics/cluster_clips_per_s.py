"""Clips of the window's calls of stage cluster that came out whole, over all
the time of those calls (host clock; the last call may end past the
requested seconds, and the time counted runs to its end)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
