"""Peaks of one H100 and the least time of each measured operation,
counted from the operation's own work, whatever implements it.

Published peaks (NVIDIA H100 SXM data sheet, dense): TF32 495 TFLOP/s,
int8 1,979 TOP/s, HBM3 3.35 TB/s, at the 700 W limit.
A least time is ``max(operations / peak, bytes / bandwidth)`` with each
input byte read once and each output byte written once (the arithmetic
of ``chip_smoke.py``'s ``bound_ms``, with the work counted as the
operation needs it rather than as a kernel folds it)."""

from __future__ import annotations

import math

__all__ = ["PEAK_TF32", "PEAK_INT8", "PEAK_BYTES",
           "least_s", "mel_frontend_work", "mel_frontend_least_s",
           "int8_gemm_least_s", "peak_for"]

PEAK_TF32 = 495e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def peak_for(precision: str) -> float:
    """The fastest arithmetic a precision admits on the card: fp32 may
    run in TF32 (cuDNN's default), so its peak is TF32's."""
    return {"float32": PEAK_TF32, "int8": PEAK_INT8}[precision]


def least_s(operations: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(operations / peak, nbytes / PEAK_BYTES)


def mel_frontend_work(batch: int, samples: int, n_fft: int, hop: int,
                      n_mels: int) -> tuple[float, float]:
    """``(operations, bytes)`` of mel features of ``batch`` waves of
    ``samples`` each, centre-padded by ``n_fft / 2``: per frame a real
    FFT of ``n_fft`` points (2.5 N log2 N), the power of its
    ``n_fft/2 + 1`` bins (3 each) and the mel product (2 per bin and
    band); the wave read once and the features written once, in fp32."""
    frames = 1 + samples // hop
    bins = n_fft // 2 + 1
    per_frame = 2.5 * n_fft * math.log2(n_fft) + 3 * bins + 2 * bins * n_mels
    ops = batch * frames * per_frame
    nbytes = 4.0 * batch * (samples + frames * n_mels)
    return ops, nbytes


def mel_frontend_least_s(batch: int, samples: int, n_fft: int, hop: int,
                         n_mels: int) -> float:
    """K1's least time (fp32 cell: the TF32 peak)."""
    ops, nbytes = mel_frontend_work(batch, samples, n_fft, hop, n_mels)
    return least_s(ops, nbytes, PEAK_TF32)


def int8_gemm_least_s(m: int, k: int, n: int, x_bytes: int = 4,
                      out_bytes: int = 4) -> float:
    """K3's least time for one static-scale int8 product ``[M, K] @ [K,
    N] -> [M, N]``: 2·M·K·N operations at the int8 peak; its input read
    once as the layer hands it (fp32 activations, quantized on the way),
    the int8 weights once, the fp32 output written once."""
    return least_s(2.0 * m * k * n,
                   x_bytes * m * k + k * n + out_bytes * m * n, PEAK_INT8)
