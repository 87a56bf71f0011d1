"""DSP primitives (port of ``ops/signal.py``): amplitude, convolution,
reverb, filters, overlap-add.

The reference's SpeechBrain DSP copies (signal_processing.py:16-565,
audio_signal.py:17-486): ``compute_amplitude``, normalize/rescale,
dB <-> amplitude, ``convolve1d`` (both of its branches),
``reverberate`` (RIR convolution with direct-path alignment and level
restoration), ``notch_filter``, ``overlap_and_add`` and the Gabor
impulse response of learnable filterbanks. Every function takes
``[..., time]`` tensors on either device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["compute_amplitude", "normalize_amplitude", "rescale",
           "db_to_amplitude", "amplitude_to_db", "convolve1d", "reverberate",
           "notch_filter", "overlap_and_add", "gabor_impulse_response"]


def compute_amplitude(waveform: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None,
                      amp_type: str = "avg",
                      scale: str = "linear") -> torch.Tensor:
    """Average or peak amplitude per waveform (signal_processing.py:16-70)."""
    if amp_type == "avg":
        if lengths is None:
            out = waveform.abs().mean(dim=-1, keepdim=True)
        else:
            out = (waveform.abs().sum(dim=-1, keepdim=True)
                   / lengths[..., None])
    elif amp_type == "peak":
        out = waveform.abs().amax(dim=-1, keepdim=True)
    else:
        raise ValueError(f"unknown amp_type {amp_type!r}")
    if scale == "linear":
        return out
    if scale == "dB":
        return torch.clamp(20 * torch.log10(torch.clamp(out, min=1e-14)),
                           min=-80.0)
    raise ValueError(f"unknown scale {scale!r}")


def normalize_amplitude(waveform: torch.Tensor, amp_type: str = "avg",
                        eps: float = 1e-14) -> torch.Tensor:
    """Divide by the amplitude (signal_processing.py normalize)."""
    return waveform / (compute_amplitude(waveform, amp_type=amp_type) + eps)


def rescale(waveform: torch.Tensor, target_lvl: float, amp_type: str = "avg",
            scale: str = "linear") -> torch.Tensor:
    """Normalize, then scale to a target level (signal_processing.py
    rescale)."""
    out = normalize_amplitude(waveform, amp_type)
    if scale == "linear":
        return target_lvl * out
    if scale == "dB":
        return db_to_amplitude(torch.as_tensor(
            target_lvl, dtype=torch.float32, device=out.device)) * out
    raise ValueError(f"unknown scale {scale!r}")


def db_to_amplitude(db: torch.Tensor, ref: float = 1.0,
                    power: float = 0.5) -> torch.Tensor:
    return ref * torch.pow(10.0, db / 10.0) ** power


def amplitude_to_db(amp: torch.Tensor, eps: float = 1e-14) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(amp.abs(), min=eps))


def convolve1d(waveform: torch.Tensor, kernel: torch.Tensor,
               padding: int | tuple = 0, use_fft: bool = True,
               rotation_index: int | torch.Tensor = 0) -> torch.Tensor:
    """1-D convolution of ``[B, T]`` with a ``[K]`` or per-row ``[B, K]``
    kernel (signal_processing.py:157-277), each branch as the reference
    has it (they disagree there, and both are kept):

    * ``use_fft=True``: the kernel zero-padded to the (padded) signal's
      length; the product is CIRCULAR true convolution at that length,
      rotated left by ``rotation_index`` (an int, or a tensor: one value,
      or one per row ``[B]``). Reverberation relies on the wrap-around
      for its direct-path alignment.
    * ``use_fft=False``: ``conv1d``'s semantics, CROSS-correlation (no
      kernel flip), valid size ``T_padded - K + 1``, each row with its
      kernel.
    """
    if isinstance(padding, int):
        padding = (padding, padding)
    x = F.pad(waveform, tuple(padding))
    if kernel.dim() == 1:
        kernel = kernel.expand(x.shape[0], -1)

    if use_fft:
        T = x.shape[-1]
        kernel = kernel[..., :T]        # reference: a longer kernel keeps T
        y = torch.fft.irfft(torch.fft.rfft(x, n=T)
                            * torch.fft.rfft(kernel, n=T), n=T)
        if isinstance(rotation_index, int):
            return torch.roll(y, -rotation_index, dims=-1) \
                if rotation_index else y
        rot = torch.as_tensor(rotation_index, device=y.device).reshape(-1, 1)
        idx = (torch.arange(T, device=y.device)[None, :] + rot) % T
        return torch.gather(y, -1, idx.expand(y.shape))
    B, T = x.shape
    out = F.conv1d(x[None], kernel.to(x.dtype)[:, None, :], groups=B)
    return out[0]


def reverberate(waveform: torch.Tensor, rir: torch.Tensor,
                rescale_amp: str = "avg") -> torch.Tensor:
    """RIR convolution with direct-path alignment and level restoration
    (signal_processing.py:280-352): circular FFT convolution at the
    wave's length, rotated to the direct path (the RIR's largest
    magnitude), rescaled to the dry signal's amplitude."""
    orig_amp = compute_amplitude(waveform, amp_type=rescale_amp)
    direct = torch.atleast_1d(torch.argmax(rir.abs(), dim=-1))
    wet = convolve1d(waveform, rir, padding=0, use_fft=True,
                     rotation_index=direct)
    new_amp = compute_amplitude(wet, amp_type=rescale_amp)
    return wet * orig_amp / torch.clamp(new_amp, min=1e-14)


def notch_filter(notch_freq: float, filter_width: int = 101,
                 notch_width: float = 0.05, device=None) -> torch.Tensor:
    """FIR band-rejection kernel (signal_processing.py notch_filter),
    float32 on ``device`` (default the CPU), with torch's PERIODIC
    Blackman window (denominator N)."""
    pad = filter_width // 2
    inputs = torch.arange(filter_width, dtype=torch.float32,
                          device=device) - pad
    notch_freq = notch_freq + notch_width

    def sinc(x):
        safe = torch.where(x == 0, torch.ones_like(x), x)
        return torch.where(x == 0, torch.ones_like(x), torch.sin(x) / safe)

    k = torch.arange(filter_width, dtype=torch.float32, device=device)
    blackman = (0.42 - 0.5 * torch.cos(2 * math.pi * k / filter_width)
                + 0.08 * torch.cos(4 * math.pi * k / filter_width))
    hlpf = sinc(3.0 * (notch_freq - notch_width) * inputs) * blackman
    hlpf = hlpf / hlpf.sum()
    hhpf = sinc(3.0 * (notch_freq + notch_width) * inputs) * blackman
    hhpf = -hhpf / hhpf.sum()
    hhpf[pad] += 1.0
    return hlpf + hhpf


def overlap_and_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
    """``[..., n_frames, frame_len] -> [..., T]`` overlap-add
    (signal_processing.py overlap_and_add), one ``index_add``."""
    *batch, n_frames, frame_len = frames.shape
    total = frame_step * (n_frames - 1) + frame_len
    rows = frames.reshape(-1, n_frames * frame_len)
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * frame_step
           + torch.arange(frame_len, device=frames.device)[None, :])
    out = rows.new_zeros((rows.shape[0], total)).index_add(
        1, idx.reshape(-1), rows)
    return out.reshape(tuple(batch) + (total,))


def gabor_impulse_response(t: torch.Tensor, center: torch.Tensor,
                           fwhm: torch.Tensor) -> torch.Tensor:
    """Complex Gabor filters ``[n, len(t)]`` (audio_signal.py gabor
    impulse response), complex64 for float32 inputs."""
    denominator = 1.0 / (math.sqrt(2.0 * math.pi) * fwhm)
    gaussian = torch.exp(torch.outer(1.0 / (2.0 * fwhm ** 2), -t ** 2))
    sinusoid = torch.exp(1j * torch.outer(center, t))
    return denominator[:, None] * sinusoid * gaussian
