"""The device allocator's peak over the window
(``torch.cuda.max_memory_allocated``), GiB."""


def read(run):
    if run.kind != "sample" or not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
