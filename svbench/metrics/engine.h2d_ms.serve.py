"""Mean device time of the engine's copy of a batch to the card and its
dequantization: the CUDA events of the program's ``engine.h2d`` spans of
the traced window (a pageable copy holds the host until the stream's
earlier work is done, so the spans' host time is not the copy's)."""

from svbench.harness.spans import device_ms, window_spans


def read(r):
    return device_ms(window_spans(r), "engine.h2d")
