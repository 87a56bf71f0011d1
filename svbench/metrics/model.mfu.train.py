"""The reference's forward, backward and head FLOPs of a step, times the
window's steps, over the window's seconds, as a share of the precision's
peak (fp32: TF32's 495 TFLOP/s), in percent."""


def read(r):
    if "model.flops_per_step" not in r or r.get("trace") is None:
        return None
    return (100.0 * r["model.flops_per_step"] * r["steps"] / r["window_s"]
            / r["model.peak"])
