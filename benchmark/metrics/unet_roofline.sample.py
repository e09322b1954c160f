"""The least time of the chain's UNet work (the reference's count at the
cell's shapes: the larger of its FLOPs over the bf16 peak and its bytes
over HBM bandwidth) over the device time of the kernels inside the
``sample`` span, in percent."""


def read(run):
    from harness import flops, trace

    if run.kind != "sample" or run.trace is None or "unet" not in run.work:
        return None
    busy = trace.device_seconds_in(run.trace, "sample")
    if not busy:
        return None
    least = flops.least_seconds(run.work["unet"], run.work["unet_bytes"],
                                flops.BF16_PEAK)
    return 100.0 * least * run.traced_units / busy
