"""Device-to-host reads per greedy iteration (``select.host_reads`` over
``select.iterations``, the program's own counters in
``acav100m_torch.tracing``): each read waits for the device, so each is a
sync the host's dispatch cannot run past. None where the program counts
neither."""


def read(run):
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    iterations, reads = counts.get("select.iterations"), counts.get("select.host_reads")
    if not iterations or reads is None:
        return None
    return reads / iterations
