"""Device milliseconds a step of the kernels inside the ``optim`` span
(AdamW's step), in the traced sub-window."""


def read(run):
    from harness import trace

    if run.kind != "train" or run.trace is None:
        return None
    busy = trace.device_seconds_in(run.trace, "optim")
    if not busy:
        return None
    return 1e3 * busy / run.traced_units
