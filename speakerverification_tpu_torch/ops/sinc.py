"""Parameterized sinc band-pass filterbank (port of ``ops/sinc.py``).

Band-passes parameterized by learnable (low, band) pairs, mel-initialized,
with a half Hamming window on one of two grids (``window_grid``),
built each forward in fp32 as a dense ``[C, 1, k]`` kernel, then a VALID
strided conv in the wave's dtype. ``[B, T] -> [B, C, frames]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SincConv", "sinc_init_frequencies"]


def _hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def sinc_init_frequencies(out_channels: int, sample_rate: int,
                          min_low_hz: float = 50.0, min_band_hz: float = 50.0,
                          low_hz: float = 30.0):
    """Mel-spaced initial (low_hz, band_hz) pairs (SincNet init)."""
    high_hz = sample_rate / 2.0 - (min_low_hz + min_band_hz)
    mel = np.linspace(_hz_to_mel_htk(low_hz), _hz_to_mel_htk(high_hz),
                      out_channels + 1)
    hz = _mel_to_hz_htk(mel)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


class SincConv(nn.Module):
    def __init__(self, out_channels: int, kernel_size: int = 251,
                 stride: int = 1, sample_rate: int = 16000,
                 min_low_hz: float = 50.0, min_band_hz: float = 50.0,
                 init_low_hz: float = 30.0, window_grid: str = "arange"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        if window_grid not in ("arange", "linspace"):
            raise ValueError(f"window_grid must be 'arange' or 'linspace', "
                             f"got {window_grid!r}")
        self.kernel_size, self.stride = kernel_size, stride
        self.window_grid = window_grid
        self.sample_rate = sample_rate
        self.min_low_hz, self.min_band_hz = min_low_hz, min_band_hz
        low, band = sinc_init_frequencies(out_channels, sample_rate,
                                          min_low_hz, min_band_hz,
                                          low_hz=init_low_hz)
        self.low_hz = nn.Parameter(torch.from_numpy(low))
        self.band_hz = nn.Parameter(torch.from_numpy(band))

    def filters(self) -> torch.Tensor:
        """The band-pass filters ``[C, k]``, built in fp32."""
        low_hz = self.low_hz.float()
        band_hz = self.band_hz.float()
        dev = low_hz.device
        low = self.min_low_hz + low_hz.abs()
        high = torch.clamp(low + self.min_band_hz + band_hz.abs(),
                           self.min_low_hz, self.sample_rate / 2.0)
        band = (high - low)[:, None]

        half = (self.kernel_size - 1) // 2
        n_left = 2.0 * math.pi * torch.arange(-half, 0, dtype=torch.float32,
                                              device=dev) / self.sample_rate
        # half Hamming window over the left lobe: the integer grid
        # (RawNet3's sinc bank) or SincConv_fast's linspace(0, k/2 - 1,
        # k//2), whose step is not 1 (the RawNet2 family's)
        if self.window_grid == "linspace":
            grid = torch.linspace(0.0, self.kernel_size / 2.0 - 1.0,
                                  self.kernel_size // 2, device=dev)
        else:
            grid = torch.arange(half, dtype=torch.float32, device=dev)
        window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * grid / self.kernel_size)

        f_low = low[:, None] * n_left[None, :]
        f_high = high[:, None] * n_left[None, :]
        left = (torch.sin(f_high) - torch.sin(f_low)) / (n_left[None, :] / 2.0)
        left = left * window[None, :]
        filters = torch.cat([left, 2.0 * band, torch.flip(left, dims=[1])],
                            dim=1)
        return filters / (2.0 * band)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[B, T]`` → ``[B, C, frames]`` (VALID, strided)."""
        kernel = self.filters().to(x.dtype)[:, None, :]     # [C, 1, k]
        return F.conv1d(x[:, None, :], kernel, stride=self.stride)
