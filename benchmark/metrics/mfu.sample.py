"""The FLOPs of every image completed in the window (the reference's count
on ``meta``, 2 FLOPs a multiply-add: both conditioning batches, every
UNet evaluation and its SPADE tables, the decode) over the window's
seconds, against the bf16 peak of 989 TFLOP/s, in percent."""


def read(run):
    from harness import flops

    if (run.kind != "sample" or "batch_flops" not in run.work
            or not run.images):
        return None
    per_image = run.work["batch_flops"] / run.work["batch"]
    return 100.0 * per_image * run.images / run.window_s / flops.BF16_PEAK
