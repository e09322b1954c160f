"""The least time of the decode (the reference's count: the larger of its
FLOPs over the TF32 tensor peak and its bytes over HBM bandwidth) over
the device time of the kernels inside the ``decode`` span, in percent."""


def read(run):
    from harness import flops, trace

    if run.kind != "sample" or run.trace is None or "decode" not in run.work:
        return None
    busy = trace.device_seconds_in(run.trace, "decode")
    if not busy:
        return None
    least = flops.least_seconds(run.work["decode"],
                                run.work["decode_bytes"], flops.TF32_PEAK)
    return 100.0 * least * run.traced_units / busy
