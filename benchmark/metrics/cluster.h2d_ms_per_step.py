"""Host-to-device copy time of the traced window per batch that
``stack_batch`` built (training steps and assignment batches); the few
scalar copies beside them are counted too and are microseconds."""


def read(run):
    copies = run.timeline.copies("HtoD")
    steps = run.info["train_steps"] + run.info["assign_batches"]
    if not copies or not steps:
        return None
    return 1e3 * run.timeline.seconds(copies) / steps
