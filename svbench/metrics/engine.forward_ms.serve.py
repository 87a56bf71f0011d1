"""Mean device time of the engine's forward per batch the batcher ran
(CUDA events around each ``embed`` call, traced run only)."""

from svbench.harness.readers import mean_ms


def read(r):
    return mean_ms(r.get("engine.forward_ms"))
