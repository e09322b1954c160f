"""Percent of the traced sub-window of whole batches in which no device
operation ran: 1 - (union of kernel intervals) / wall."""


def read(run):
    from harness import trace

    if run.kind != "sample" or run.trace is None:
        return None
    idle = trace.idle_share(run.trace)
    return None if idle is None else 100.0 * idle
