"""K1 (``mel_kernel``): least time at the extraction batch's shape (640
crops of 2 s at 8 kHz) over its mean device time per launch, in percent."""

from svbench.harness.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "k1")
