"""Share (%) of the device's peak at the configuration's precision that
the untraced window's epochs reach: an epoch's FLOPs, counted from shapes
by the reference (``flops`` of its model and job), over the epoch's wall
time."""

PEAK_KEY = {"float32": "fp32_flops", "tf32": "tf32_flops",
            "bfloat16": "bf16_flops"}


def read(ctx):
    peaks = ctx["peaks"]
    if not peaks or not ctx["flops_per_epoch"]:
        return None
    epoch_s = ctx["window_s"] / ctx["epochs"]
    peak = peaks[PEAK_KEY[ctx["precision"]]]
    return 100.0 * ctx["flops_per_epoch"] / (epoch_s * peak)
