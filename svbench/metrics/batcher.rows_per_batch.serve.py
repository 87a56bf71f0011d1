"""Rows per batch the batcher sent to the engine in the window: the mean
``rows`` attribute of the program's ``batcher.assemble`` spans of the
traced window (None where its spans carry none)."""

import statistics

from svbench.harness.spans import named, window_spans


def read(r):
    spans = window_spans(r)
    rows = [s.attrs["rows"] for s in named(spans or [], "batcher.assemble")
            if "rows" in s.attrs]
    return statistics.fmean(rows) if rows else None
