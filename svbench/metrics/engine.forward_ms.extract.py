"""Mean device time of the engine's int8 forward per batch of 32 files
× 20 crops (CUDA events around each ``embed_fn`` call, traced run only)."""

from svbench.harness.readers import mean_ms


def read(r):
    return mean_ms(r.get("engine.forward_ms"))
