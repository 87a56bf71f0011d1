"""Mean host time between one ``embed_fn`` call's return and the next
call within a pass: the eval loader's reading, cropping and stacking
that the forward waits for (traced run only)."""

from svbench.harness.readers import mean_ms


def read(r):
    return mean_ms(r.get("loader.gap_ms"))
