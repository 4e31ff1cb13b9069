"""Megabytes (1e6 bytes) that the extraction's ``_cache.pkl`` rewrites
wrote per batch the window ran (``extract.cache_bytes`` over
``extract.batches``, the program's own counters in
``acav100m_torch.tracing``); None where the program counts neither."""


def read(run):
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    batches, written = counts.get("extract.batches"), counts.get("extract.cache_bytes")
    if not batches or written is None:
        return None
    return written / 1e6 / batches
