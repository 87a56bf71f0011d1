"""K1 (``mel_kernel``): least time at the training batch's shape over its
mean device time per launch in the trace, in percent."""

from svbench.harness.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "k1")
