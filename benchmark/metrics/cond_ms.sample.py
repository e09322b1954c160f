"""Milliseconds a batch inside the ``cond`` spans (both conditioning
calls), on the device's timeline, in the traced sub-window."""


def read(run):
    if run.kind != "sample" or run.trace is None:
        return None
    spans = run.trace.spans_named("cond")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / run.traced_units
