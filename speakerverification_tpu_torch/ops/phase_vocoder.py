"""STFT phase vocoder: time stretch and pitch shift with
``librosa.effects.pitch_shift``'s semantics (port of
``ops/phase_vocoder.py``).

* ``time_stretch(y, rate)``: a phase vocoder over a centred hann STFT
  (per-bin expected phase advance, the wrapped phase deviation, the
  accumulated synthesis phase, the magnitude interpolated linearly
  between the two analysis frames that straddle each output frame);
* ``pitch_shift(y, n_steps)``: stretch by ``2**(-n/bins)``, then
  Fourier-resample back to the input's length, so f0 scales by
  ``2**(n/bins)`` and the duration stays.

The training loader calls this from its worker threads on host data,
so it is numpy: its FFTs start no thread pool of their own, and eight
workers do not oversubscribe the host as eight intra-op pools would.
It computes in float64 and returns float32 (the stretch, as in the JAX
package, is float32 before the resampling).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["stft", "istft", "phase_vocoder", "time_stretch", "pitch_shift",
           "fourier_resample"]


def _hann(n: int) -> np.ndarray:
    # periodic hann (librosa/scipy sym=False)
    return 0.5 * (1.0 - np.cos(2.0 * math.pi * np.arange(n) / n))


def stft(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Centred hann STFT of ``y [T]`` → complex ``[1 + n_fft//2, frames]``."""
    pad = n_fft // 2
    y = np.pad(np.asarray(y, np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (y.shape[0] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.fft.rfft(y[idx] * _hann(n_fft)[None, :], axis=-1).T


def _overlap_add(frames: np.ndarray, hop: int) -> np.ndarray:
    n_frames, n_fft = frames.shape
    out = np.zeros(n_fft + hop * (n_frames - 1), frames.dtype)
    for i in range(n_frames):
        out[i * hop:i * hop + n_fft] += frames[i]
    return out


def istft(D: np.ndarray, n_fft: int = 2048, hop: int = 512,
          length: Optional[int] = None) -> np.ndarray:
    """Inverse of :func:`stft`, normalized by the overlapped squared
    window."""
    frames = np.fft.irfft(D.T, n=n_fft, axis=-1)          # [frames, n_fft]
    win = _hann(n_fft)
    frames = frames * win[None, :]
    y = _overlap_add(frames, hop)
    wss = _overlap_add(np.broadcast_to(win ** 2, frames.shape), hop)
    y = y / np.maximum(wss, 1e-10)
    y = y[n_fft // 2:]
    if length is not None:
        y = y[:length]
        y = np.pad(y, (0, max(0, length - y.shape[0])))
    return y


def phase_vocoder(D: np.ndarray, rate: float, hop: int = 512) -> np.ndarray:
    """Stretch the STFT ``D [bins, frames]`` by ``rate`` (> 1 speeds up)."""
    n_bins, n_frames = D.shape
    time_steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, math.pi * hop, n_bins)

    idx0 = np.minimum(time_steps.astype(int), n_frames - 1)
    idx1 = np.minimum(idx0 + 1, n_frames - 1)
    alpha = time_steps - np.floor(time_steps)

    c0, c1 = D[:, idx0], D[:, idx1]                       # [bins, steps]
    mag = (1.0 - alpha)[None, :] * np.abs(c0) + alpha[None, :] * np.abs(c1)

    # wrapped per-step phase deviation → accumulated synthesis phase
    dphase = np.angle(c1) - np.angle(c0) - phi_advance[:, None]
    dphase = dphase - 2.0 * math.pi * np.round(dphase / (2.0 * math.pi))
    inc = phi_advance[:, None] + dphase
    phase = np.angle(D[:, :1]) + np.concatenate(
        [np.zeros_like(inc[:, :1]), np.cumsum(inc, axis=1)[:, :-1]], axis=1)
    return mag * np.exp(1j * phase)


def fourier_resample(y: np.ndarray, num: int) -> np.ndarray:
    """``scipy.signal.resample``-style FFT resampling of ``y [T]`` to
    ``num`` samples."""
    n = y.shape[0]
    Y = np.fft.rfft(y)
    n_out_bins = num // 2 + 1
    if n_out_bins <= Y.shape[0]:
        Y = Y[:n_out_bins]
    else:
        Y = np.pad(Y, (0, n_out_bins - Y.shape[0]))
    return np.fft.irfft(Y, n=num) * (num / n)


def time_stretch(y: np.ndarray, rate: float, n_fft: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """Stretch ``y`` to ``round(len(y) / rate)`` samples at constant
    pitch."""
    y = np.asarray(y)
    D = phase_vocoder(stft(y, n_fft, hop), rate, hop)
    out = istft(D, n_fft, hop, length=int(round(y.shape[0] / rate)))
    return out.astype(np.float32)


def pitch_shift(y: np.ndarray, n_steps: float,
                bins_per_octave: int = 12, n_fft: int = 2048,
                hop: int = 512) -> np.ndarray:
    """f0 × 2^(n_steps/bins_per_octave), the duration kept (librosa's
    ``sr`` argument is dropped: the shift does not depend on it)."""
    y = np.asarray(y, np.float32)
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    return fourier_resample(time_stretch(y, rate, n_fft, hop),
                            y.shape[0]).astype(np.float32)
