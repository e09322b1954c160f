"""Images of every whole batch completed in the window over the time from
the window's start to the end of the last of them (host clock, the
device synchronised after each batch)."""


def read(run):
    from harness.common import rate

    return rate(run.images, run.window_s) if run.kind == "sample" else None
