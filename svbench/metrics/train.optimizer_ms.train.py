"""Stream time a step of the train step's optimizer (from the CUDA event at
the start of the program's ``train.optimizer`` span, one a step, to the
one at its end: the update's kernels and the stream's idle time while
the host launches them), over the traced window's steps."""

from svbench.harness.spans import per_step_stream_ms, window_spans


def read(r):
    return per_step_stream_ms(window_spans(r), "train.optimizer")
