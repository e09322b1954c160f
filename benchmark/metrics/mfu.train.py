"""The forward and backward FLOPs of the reference's training step on
``meta`` (encode, conditioning, both stages' losses; 2 FLOPs a multiply-
add) per image, times the images trained in the window, over the
window's seconds, against the bf16 peak of 989 TFLOP/s, in percent."""


def read(run):
    from harness import flops

    if run.kind != "train" or "step" not in run.work or not run.images:
        return None
    per_image = run.work["step"] / run.work["batch"]
    return 100.0 * per_image * run.images / run.window_s / flops.BF16_PEAK
