"""Host time of the selection's dispatch per greedy iteration: the self
time of ``span.select.dispatch`` (the batch's ids and mask to the device,
then ``BatchGreedySelector._step``: index, score, top-k, fold, statistics,
all enqueued) over ``select.iterations``. Read from the program's own spans
(``acav100m_torch.tracing``); None where the program records none."""


def read(run):
    try:
        from acav100m_torch import tracing
    except ImportError:
        return None
    iterations = tracing.counters().get("select.iterations")
    dispatch = tracing.self_ns("span.select.dispatch")
    if not iterations or not dispatch:
        return None
    return dispatch / 1e3 / iterations
