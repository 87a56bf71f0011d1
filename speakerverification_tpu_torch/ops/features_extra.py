"""Extra feature-stack ops (port of ``ops/features_extra.py``): deltas,
context window, ISTFT, the SpeechBrain filterbank.

The SpeechBrain feature copy (features_speechbrain.py:44-920): ``Deltas``
(a moving-regression derivative over time), ``ContextWindow`` (splicing
of ±context frames), ``ISTFT`` (inverse STFT by overlap-add with
squared-window normalization) and ``Filterbank`` (HTK-mel triangular,
rectangular or gaussian filters with a per-sequence dB clamp: another
mel construction than the torchaudio-slaney one of ``ops/frontend.py``).
Features are ``[B, T, F]``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from speakerverification_tpu_torch.ops.frontend import (
    FrontendConfig,
    dft_matrices,
)
from speakerverification_tpu_torch.ops.signal import overlap_and_add

__all__ = ["deltas", "context_window", "istft",
           "speechbrain_fbank_matrix", "speechbrain_log_fbank"]


def deltas(x: torch.Tensor, window_length: int = 5) -> torch.Tensor:
    """Time derivative by linear regression over ±n frames, edges
    repeated (features_speechbrain ``Deltas``). ``x``: [B, T, F]."""
    n = (window_length - 1) // 2
    denom = n * (n + 1) * (2 * n + 1) / 3.0
    kernel = torch.arange(-n, n + 1, dtype=x.dtype, device=x.device) / denom
    B, T, Fdim = x.shape
    xt = F.pad(x.transpose(1, 2), (n, n), mode="replicate")   # [B, F, T+2n]
    out = F.conv1d(xt.reshape(B * Fdim, 1, -1), kernel.view(1, 1, -1))
    return out.reshape(B, Fdim, T).transpose(1, 2)


def context_window(x: torch.Tensor, left_frames: int = 5,
                   right_frames: int = 5) -> torch.Tensor:
    """Frame splicing (features_speechbrain ``ContextWindow``): zero
    borders and the channel-major layout ``out[..., c*(l+r+1) + i]`` =
    channel ``c`` at offset ``i - left``. [B, T, F] -> [B, T, F*(l+r+1)]."""
    B, T, Fdim = x.shape
    padded = F.pad(x, (0, 0, left_frames, right_frames))
    stacked = torch.stack([padded[:, i:i + T]
                           for i in range(left_frames + right_frames + 1)],
                          dim=-1)                             # [B, T, F, ctx]
    return stacked.reshape(B, T, Fdim * (left_frames + right_frames + 1))


@functools.lru_cache(maxsize=16)
def _istft_np(cfg: FrontendConfig):
    n_fft = cfg.n_fft
    K = n_fft // 2 + 1
    angle = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(K)[None, :] \
        / n_fft
    weight = np.ones(K)
    weight[1:-1 if n_fft % 2 == 0 else None] = 2.0
    cos_b, _ = dft_matrices(n_fft, cfg.win_length, cfg.window)
    return ((np.cos(angle) * weight / n_fft).astype(np.float32),
            (np.sin(angle) * weight / n_fft).astype(np.float32),
            cos_b[:, 0].astype(np.float32))              # w * cos(0) = w


_device_istft: dict = {}


def _istft_constants(cfg: FrontendConfig, device):
    """The inverse real-DFT bases (unwindowed) ``[n_fft, K]`` and the
    synthesis window, built once per (config, device)."""
    key = (cfg, str(torch.device(device)))
    if key not in _device_istft:
        with torch.inference_mode(False):
            _device_istft[key] = tuple(torch.as_tensor(a, device=device)
                                       for a in _istft_np(cfg))
    return _device_istft[key]


def istft(real: torch.Tensor, imag: torch.Tensor,
          cfg: FrontendConfig = FrontendConfig(),
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT by synthesis-window overlap-add (features_speechbrain
    ``ISTFT``). Inputs ``[B, frames, bins]``, as the frontend's bases give
    them: its "imag" is frames @ sin = -Im(rFFT), so the synthesis adds."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    inv_cos, inv_sin, window = _istft_constants(cfg, real.device)
    frames = (torch.einsum("bfk,nk->bfn", real, inv_cos)
              + torch.einsum("bfk,nk->bfn", imag, inv_sin))    # [B, F, n_fft]
    # synthesis window = analysis window; normalized by the sum of squares
    sig = overlap_and_add(frames * window, hop)
    wsq = overlap_and_add((window ** 2).expand(frames.shape), hop)
    sig = sig / torch.clamp(wsq, min=1e-8)
    sig = sig[..., n_fft // 2:]
    if length is not None:
        sig = sig[..., :length]
    return sig


def _htk_mel(hz: float) -> float:
    return 2595.0 * math.log10(1.0 + hz / 700.0)


def _htk_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def speechbrain_fbank_matrix(n_mels: int = 40, f_min: float = 0.0,
                             f_max: float = 8000.0, n_fft: int = 400,
                             sample_rate: int = 16000,
                             filter_shape: str = "triangular") -> np.ndarray:
    """Mel filter matrix ``[n_fft//2+1, n_mels]`` with the SpeechBrain
    construction (features_speechbrain.py:353-683): HTK mel points,
    filters by central frequency and band over the frequency axis
    ``linspace(0, sample_rate // 2, n_stft)`` (the reference's INTEGER
    halving of odd sample rates), triangular, rectangular or gaussian
    (smooth factor 2), in float32 as the reference builds it."""
    n_stft = n_fft // 2 + 1
    mel = np.linspace(_htk_mel(f_min), _htk_mel(f_max), n_mels + 2,
                      dtype=np.float32)
    hz = _htk_hz(mel).astype(np.float32)
    band = (hz[1:] - hz[:-1])[:-1][:, None]               # [n_mels, 1]
    f_central = hz[1:-1][:, None]                         # [n_mels, 1]
    all_freqs = np.linspace(0, sample_rate // 2, n_stft,
                            dtype=np.float32)[None, :]

    if filter_shape == "triangular":
        slope = (all_freqs - f_central) / band
        fb = np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope))
    elif filter_shape == "rectangular":
        fb = ((all_freqs >= f_central - band)
              & (all_freqs <= f_central + band)).astype(np.float64)
    elif filter_shape == "gaussian":
        fb = np.exp(-0.5 * ((all_freqs - f_central) / (band / 2.0)) ** 2)
    else:
        raise ValueError(f"unknown filter_shape {filter_shape!r}")
    return fb.T.astype(np.float32)                        # [n_stft, n_mels]


def speechbrain_log_fbank(fbanks: torch.Tensor, power_spectrogram: float = 2,
                          amin: float = 1e-10, ref_value: float = 1.0,
                          top_db: float = 80.0) -> torch.Tensor:
    """Linear FBANKs -> log FBANKs with the SpeechBrain dB clamp
    (features_speechbrain.py:683-707): multiplier 10 (power spectra) or
    20, and the dynamic-range floor taken per SEQUENCE over the last two
    axes (time x mel)."""
    multiplier = 10.0 if power_spectrogram == 2 else 20.0
    db = multiplier * torch.log10(torch.clamp(fbanks, min=amin))
    db = db - multiplier * math.log10(max(amin, ref_value))
    floor = db.amax(dim=(-2, -1), keepdim=True) - top_db
    return torch.maximum(db, floor)
