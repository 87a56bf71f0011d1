"""Mean host time of a train step (the host's launch time a step): the
program's ``train.step`` spans of the traced window."""

from svbench.harness.spans import host_ms, window_spans


def read(r):
    return host_ms(window_spans(r), "train.step")
