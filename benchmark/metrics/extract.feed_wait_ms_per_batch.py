"""Time the extraction's main thread spent blocked on its feed
(``span.extract.feed_wait``: waiting for the prefetch thread's next decoded,
collated and staged batch) per batch the window ran (``extract.batches``).
Read from the program's own spans (``acav100m_torch.tracing``, on the
device trace's clock); None where the program records none."""


def read(run):
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    batches = tracing.counters().get("extract.batches")
    wait = tracing.total_ns("span.extract.feed_wait")
    if not batches or not wait:
        return None
    return wait / 1e6 / batches
