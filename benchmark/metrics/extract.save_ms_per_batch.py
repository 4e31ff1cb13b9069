"""Time the extraction's main thread spent writing its outputs per batch
the window ran: the ``_cache.pkl`` rewrites (``span.extract.save_cache``)
and the finished shards' pkls (``span.extract.save_output``), over
``extract.batches``. Read from the program's own spans
(``acav100m_torch.tracing``); None where the program records none."""


def read(run):
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    batches = tracing.counters().get("extract.batches")
    records = tracing.spans()
    saves = (tracing.total_ns("span.extract.save_cache", records)
             + tracing.total_ns("span.extract.save_output", records))
    if not batches or not saves:
        return None
    return saves / 1e6 / batches
