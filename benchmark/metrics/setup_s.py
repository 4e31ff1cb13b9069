"""Seconds from the start of ``run.py`` to the start of the window: imports,
traffic and weights made from the seed, kernels built or loaded from
``build/``, models loaded, the warm-up call."""


def read(run):
    return run.setup_s
