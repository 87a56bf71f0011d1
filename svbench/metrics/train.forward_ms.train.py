"""Stream time a step of the train step's forward (from the CUDA event at
each of the program's ``train.forward`` spans' start to the one at its
end, summed over a step's microbatches: the forward's kernels and the
stream's idle time while the host launches them), over the traced
window's steps."""

from svbench.harness.spans import per_step_stream_ms, window_spans


def read(r):
    return per_step_stream_ms(window_spans(r), "train.forward")
