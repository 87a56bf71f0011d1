"""The reference's FLOPs of the utterances a batch served (the window's
mean; the copies that pad a batch to its size are not counted) over the
engine's mean forward time, as a share of the precision's peak (fp32:
TF32's 495 TFLOP/s), in percent."""

from svbench.harness.readers import mean_ms


def read(r):
    ms = mean_ms(r.get("engine.forward_ms"))
    if not ms or "model.flops_per_forward" not in r:
        return None
    return 100.0 * r["model.flops_per_forward"] / (ms / 1e3) / r["model.peak"]
