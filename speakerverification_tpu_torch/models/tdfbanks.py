"""TDFbanks: the learnable time-domain filterbank (port of
``models/tdfbanks.py``; Zeghidour et al., "Learning filterbanks from raw
speech").

Optional pre-emphasis → complex Gabor conv (2·nfilters channels, the
parameter ``gabor_kernel`` in ``learnfbanks`` mode, fixed in ``Fixed``)
→ squared modulus of each (real, imag) pair → a per-filter Hann lowpass
with stride → log(1 + |·|) → optional per-filter normalization over time
(``mvn``). ``[B, T] -> [B, frames, nfilters]``, pinned to fp32 whatever
the input's dtype (the features return in it). ``gabor_kernel`` keeps
the flax layout ``[k, 1, 2·nfilters]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.ops.frontend import hz_to_mel, mel_to_hz

__all__ = ["TDFbanks", "mel_triangle_prototypes", "gabor_init"]


def mel_triangle_prototypes(nfilters: int, min_freq: float, max_freq: float,
                            fs: int, nfft: int) -> np.ndarray:
    """Triangular mel prototypes on the DFT grid: edges equally spaced in
    (HTK) mel, snapped with ``round`` to DFT bins, unit height at the
    snapped centre."""
    dfreq = fs / nfft
    mel_lo, mel_hi = hz_to_mel(min_freq, "htk"), hz_to_mel(max_freq, "htk")
    edges_hz = mel_to_hz(
        mel_lo + (mel_hi - mel_lo) / (nfilters + 1)
        * np.arange(nfilters + 2, dtype=np.float64), "htk")
    n_bins = nfft // 2 + 1
    filters = np.zeros((nfilters, n_bins))
    k = np.arange(n_bins, dtype=np.float64)
    for i in range(nfilters):
        lo = min(round(edges_hz[i] / dfreq), nfft // 2)
        ctr = min(round(edges_hz[i + 1] / dfreq), nfft // 2)
        hi = min(round(edges_hz[i + 2] / dfreq), nfft // 2)
        if ctr > lo:
            rise = (k > lo) & (k < ctr)
            filters[i, rise] = (k[rise] - lo) / (ctr - lo)
            filters[i, ctr] = 1.0
        if hi > ctr:
            fall = (k > ctr) & (k < hi)
            filters[i, fall] = (k[fall] - hi) / (ctr - hi)
    return filters


def gabor_init(nfilters: int, sample_rate: int, window_size: int,
               min_freq: float = 0.0, max_freq: float | None = None,
               nfft: int = 512) -> np.ndarray:
    """Complex Gabor kernels ``[k, 1, 2·nfilters]`` (real, imag
    interleaved) fitted to the mel triangles: centre frequency
    ``argmax·2π/nfft`` rad/sample, ``σ = √(2 ln 2)·nfft/(π·width)`` from
    the half-magnitude width, renormalized by ``√(energy·2√π·σ)``."""
    max_freq = max_freq if max_freq is not None else sample_rate / 2
    mels = mel_triangle_prototypes(nfilters, min_freq, max_freq,
                                   sample_rate, nfft)
    half_t = (window_size - 1) // 2
    t = np.arange(-half_t, half_t + 1, dtype=np.float64)
    kernels = np.zeros((window_size, 1, 2 * nfilters), np.float32)
    for i in range(nfilters):
        mag = np.sqrt(mels[i])
        center = int(np.argmax(mag))
        spread = np.flatnonzero(mag >= mag[center] / 2.0)
        width = max(spread[-1] - spread[0], 1)
        eta = center * 2.0 * math.pi / nfft               # rad / sample
        sigma = math.sqrt(2.0 * math.log(2.0)) * nfft / (math.pi * width)
        # energy = area under the triangle's magnitude spectrum
        energy = (0.5 * mels[i].max()
                  * (np.count_nonzero(mels[i] > 0) + 2) * 2 * math.pi / nfft)
        gauss = np.exp(-t ** 2 / (2.0 * sigma ** 2)) / (
            math.sqrt(2.0 * math.pi) * sigma)
        scale = math.sqrt(energy * 2.0 * math.sqrt(math.pi) * sigma)
        kernels[:, 0, 2 * i] = (scale * gauss * np.cos(eta * t)
                                ).astype(np.float32)
        kernels[:, 0, 2 * i + 1] = (scale * gauss * np.sin(eta * t)
                                    ).astype(np.float32)
    return kernels


class TDFbanks(nn.Module):
    def __init__(self, nfilters: int = 40, sample_rate: int = 16000,
                 wlen_ms: int = 25, wstride_ms: int = 10,
                 compression: str = "log", preemp: bool = False,
                 mvn: bool = False, mode: str = "learnfbanks"):
        super().__init__()
        self.nfilters, self.compression = nfilters, compression
        self.preemp, self.mvn, self.mode = preemp, mvn, mode
        self.window_size = sample_rate * wlen_ms // 1000 + 1
        self.window_stride = sample_rate * wstride_ms // 1000
        init = torch.from_numpy(gabor_init(nfilters, sample_rate,
                                           self.window_size))
        if mode == "Fixed":
            self.register_buffer("gabor_fixed", init, persistent=False)
        else:
            self.gabor_kernel = nn.Parameter(init)
        # the Hann lowpass on the reference's (n-1)-shifted grid
        k = np.arange(self.window_size)
        win = (0.5 - 0.5 * np.cos(2 * np.pi * (k - 1)
                                  / (self.window_size - 1))).astype(np.float32)
        self.register_buffer("lowpass", torch.from_numpy(np.tile(
            win[None, None, :], (nfilters, 1, 1))), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → ``[B, frames, nfilters]``."""
        in_dtype = x.dtype
        x = x.float()
        if self.preemp:
            # y[0] = x[0], y[t] = x[t] - 0.97 x[t-1], y[T] = -0.97 x[T-1]
            x = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1],
                           -0.97 * x[:, -1:]], dim=-1)
        kernel = (self.gabor_fixed if self.mode == "Fixed"
                  else self.gabor_kernel).float()
        k = self.window_size
        # 'SAME': the odd pixel after, as flax pads
        h = F.conv1d(F.pad(x[:, None], ((k - 1) // 2, k // 2)),
                     kernel.permute(2, 1, 0))                # [B, 2n, T]
        # squared modulus over the (real, imag) channel pairs
        h = h.reshape(h.shape[0], self.nfilters, 2, -1).square().sum(dim=2)
        h = F.conv1d(h, self.lowpass, stride=self.window_stride,
                     groups=self.nfilters)                   # [B, n, F]
        if self.compression == "log":
            h = torch.log(h.abs() + 1.0)
        if self.mvn:
            mean = h.mean(dim=2, keepdim=True)
            var = h.var(dim=2, unbiased=False, keepdim=True)
            h = (h - mean) / torch.sqrt(var + 1e-5)
        return h.transpose(1, 2).to(in_dtype)
