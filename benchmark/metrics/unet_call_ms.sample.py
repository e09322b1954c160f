"""Milliseconds of the ``sample`` span (the chain, on the device's
timeline) over the UNet calls it makes, in the traced sub-window; the
calls are the reference's count (stages times evaluations a stage, one
call an evaluation under batched guidance)."""


def read(run):
    if run.kind != "sample" or run.trace is None or "calls" not in run.work:
        return None
    spans = run.trace.spans_named("sample")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / (run.traced_units
                                                 * run.work["calls"])
