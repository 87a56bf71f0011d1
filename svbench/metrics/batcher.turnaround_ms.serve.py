"""Mean host time from one batch's copy back to the next batch's forward,
over the batches whose first request was waiting (replies, fill,
assembly, the copy to the card): the program's ``batcher.copy_back``,
``batcher.batch`` and ``engine.forward`` spans of the traced window."""

from svbench.harness.spans import turnaround_ms, window_spans


def read(r):
    return turnaround_ms(window_spans(r))
