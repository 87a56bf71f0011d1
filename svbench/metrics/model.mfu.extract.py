"""The reference's FLOPs of one batch over the engine's mean forward
time, as a share of the int8 peak (1,979 TOP/s), in percent."""

from svbench.harness.readers import mean_ms


def read(r):
    ms = mean_ms(r.get("engine.forward_ms"))
    if not ms or "model.flops_per_forward" not in r:
        return None
    return 100.0 * r["model.flops_per_forward"] / (ms / 1e3) / r["model.peak"]
