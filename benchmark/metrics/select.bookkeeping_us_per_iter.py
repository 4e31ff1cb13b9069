"""Host time of the selection's pool bookkeeping per greedy iteration:
``span.select.shuffle`` (the pool's shuffle and the batch drawn from it)
and ``span.select.bookkeeping`` (winners, ``setdiff1d``, the pool rebuilt,
the lists appended), over ``select.iterations``. Read from the program's
own spans (``acav100m_torch.tracing``); None where the program records
none."""


def read(run):
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    iterations = tracing.counters().get("select.iterations")
    records = tracing.spans()
    host = (tracing.total_ns("span.select.shuffle", records)
            + tracing.total_ns("span.select.bookkeeping", records))
    if not iterations or not host:
        return None
    return host / 1e3 / iterations
