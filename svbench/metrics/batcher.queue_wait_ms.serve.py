"""95th percentile of the requests' waits in the batcher's queue, from
``submit`` to the worker taking each into a batch: the program's
``batcher.queued`` spans of the traced window."""

from svbench.harness.spans import host_ms, window_spans


def read(r):
    return host_ms(window_spans(r), "batcher.queued", "p95")
