"""Batched time-domain augmentation on the device (port of
``ops/timeaugment.py``): the JAX package's redesign of the reference's
OnStreamAugment ``TimeAugment`` chains as batch tensor operations.

* ``mode='torch'``: Gain(±6 dB, p .5), Shift(±25 %, rollover, p .25),
  PolarityInversion(p ``polarity_p``), PeakNormalization (only too-loud
  rows), AddColoredNoise(3–30 dB, f_decay ±2, p .5), and with banks
  AddBackgroundNoise(3–30 dB, p .5) and ApplyImpulseResponse (the RIR's
  peak moved to t = 0, p .25), in that order.
* ``mode='np'`` (the default): exactly k ∈ [4, 10] of ten members per
  row, in list order: background noise (3–30 dB), Gaussian noise
  (5–40 dB SNR), impulse response, air absorption, gain (−6..12 dB),
  gain transition, polarity inversion, shift (±20 %, 10 ms fade), tanh
  distortion, time mask (≤ 20 %, faded edges).

``banks=None`` skips the background-noise and impulse-response members.
The noise and RIRs come from ``ops/device_augment.AugmentBanks``.

As in ``ops/device_augment.py``, :func:`draw_time_augment` draws every
random number (the Gaussian noise included) from a ``torch.Generator``
on the wave's device, and :func:`apply_time_augment` is a deterministic
function of the wave, the draw and the banks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from speakerverification_tpu_torch.ops.device_augment import (
    AugmentBanks,
    _mix_noise,
    _reverberate,
)

__all__ = ["TorchModeDraw", "NpModeDraw", "draw_time_augment",
           "apply_time_augment", "time_augment"]

N_MEMBERS = 10                  # np mode's device members


class TorchModeDraw(NamedTuple):
    gain_db: torch.Tensor       # [B]
    gain_on: torch.Tensor       # [B] bool
    shift: torch.Tensor         # [B] int samples
    shift_on: torch.Tensor
    polarity_on: torch.Tensor
    noise_snr: torch.Tensor     # colored noise
    f_decay: torch.Tensor
    white: torch.Tensor         # [B, L] standard normal
    noise_on: torch.Tensor
    bg_idx: Optional[torch.Tensor]   # banks only
    bg_snr: Optional[torch.Tensor]
    bg_on: Optional[torch.Tensor]
    rir_idx: Optional[torch.Tensor]
    rir_on: Optional[torch.Tensor]


class NpModeDraw(NamedTuple):
    sel: torch.Tensor           # [B, 10] bool: the members each row runs
    bg_idx: Optional[torch.Tensor]   # banks only
    bg_snr: Optional[torch.Tensor]
    gauss_snr: torch.Tensor
    white: torch.Tensor         # [B, L] standard normal
    rir_idx: Optional[torch.Tensor]  # banks only
    temperature: torch.Tensor
    humidity: torch.Tensor
    distance: torch.Tensor
    gain_db: torch.Tensor
    trans_db: torch.Tensor
    trans_dur: torch.Tensor     # samples
    trans_t0: torch.Tensor      # samples
    shift: torch.Tensor         # [B] int samples
    distortion: torch.Tensor
    mask_frac: torch.Tensor
    mask_pos: torch.Tensor


# ---------------------------------------------------------------------------
# The transforms ([B, L] in → [B, L] out, per-row parameters)
# ---------------------------------------------------------------------------

def _gain_db(x, db):
    return x * (10.0 ** (db / 20.0))[:, None]


def _roll(x, shift):
    """Per-row circular roll by whole samples."""
    L = x.shape[-1]
    idx = (torch.arange(L, device=x.device)[None, :] - shift[:, None]) % L
    return torch.gather(x, -1, idx.long())


def _shift_fade(x, shift, fade_len: int):
    """Roll with a linear fade about the seam."""
    y = _roll(x, shift)
    L = x.shape[-1]
    t = torch.arange(L, device=x.device)[None, :]
    s = shift[:, None] % L
    cdist = torch.minimum((t - s) % L, (s - t) % L)
    env = torch.clamp(cdist.to(x.dtype) / float(max(fade_len, 1)), 0.0, 1.0)
    return y * env


def _peak_normalize_too_loud(x):
    """Rows whose peak exceeds 1 are scaled to peak 1."""
    peak = torch.amax(torch.abs(x), dim=-1)
    scale = torch.where(peak > 1.0, 1.0 / torch.clamp(peak, min=1e-12),
                        torch.ones_like(peak))
    return x * scale[:, None]


def _colored_noise(white, f_decay):
    """Unit-RMS noise with PSD ∝ 1/f^f_decay, shaped from ``white``."""
    L = white.shape[-1]
    spec = torch.fft.rfft(white)
    f = torch.fft.rfftfreq(L, device=white.device)
    f = torch.clamp(f, min=1.0 / L)                      # DC kept finite
    amp = f[None, :] ** (-f_decay[:, None] / 2.0)
    noise = torch.fft.irfft(spec * amp, n=L)
    rms = torch.sqrt(torch.mean(noise ** 2, dim=-1, keepdim=True) + 1e-12)
    return noise / rms


def _mix_at_snr(x, unit_noise, snr_db):
    sig_rms = torch.sqrt(torch.mean(x ** 2, dim=-1) + 1e-12)
    gain = sig_rms * 10.0 ** (-snr_db / 20.0)
    return x + gain[:, None] * unit_noise


def _compensate_delay(rir):
    """Each RIR shifted so that its peak sits at t = 0."""
    L = rir.shape[-1]
    d = torch.argmax(torch.abs(rir), dim=-1)
    idx = torch.arange(L, device=rir.device)[None, :] + d[:, None]
    return torch.where(idx < L, torch.gather(rir, -1,
                                             torch.clamp(idx, max=L - 1)),
                       torch.zeros_like(rir))


def _air_absorption(x, temperature, humidity, distance, sample_rate):
    """Attenuation in dB/m ∝ f^1.8, less with humidity, more with
    temperature."""
    L = x.shape[-1]
    f_khz = torch.fft.rfftfreq(L, 1.0 / sample_rate, device=x.device) / 1000.0
    a = 0.008 * (50.0 / humidity) * (1.0 + 0.02 * (temperature - 15.0))
    att_db = (a * distance)[:, None] * (f_khz[None, :] ** 1.8)
    g = 10.0 ** (-att_db / 20.0)
    return torch.fft.irfft(torch.fft.rfft(x) * g, n=L).to(x.dtype)


def _tanh_distortion(x, amount):
    """Pre-gain 1 + 24·amount into tanh; the input's RMS restored."""
    g = 1.0 + 24.0 * amount
    y = torch.tanh(g[:, None] * x)
    rms_in = torch.sqrt(torch.mean(x ** 2, dim=-1) + 1e-12)
    rms_out = torch.sqrt(torch.mean(y ** 2, dim=-1) + 1e-12)
    return y * (rms_in / rms_out)[:, None]


def _time_mask(x, frac, pos):
    """A band of frac·L samples at relative position pos, with linear
    fades a tenth of its width."""
    L = x.shape[-1]
    band = (frac * L).to(torch.int32)
    start = (pos * (L - band).to(x.dtype)).to(torch.int32)
    fade = torch.clamp(torch.div(band, 10, rounding_mode="floor"),
                       min=1).to(x.dtype)
    t = torch.arange(L, device=x.device)[None, :].to(x.dtype)
    s = start[:, None].to(x.dtype)
    e = (start + band)[:, None].to(x.dtype)
    dip = (torch.clamp((t - s) / fade[:, None], 0.0, 1.0)
           * torch.clamp((e - t) / fade[:, None], 0.0, 1.0))
    return x * (1.0 - dip)


def _gain_transition(x, target_db, t0, dur):
    """0 dB ramping to ``target_db`` over [t0, t0 + dur) samples, then
    held."""
    L = x.shape[-1]
    t = torch.arange(L, device=x.device)[None, :].to(x.dtype)
    frac = torch.clamp((t - t0[:, None]) / torch.clamp(dur[:, None], min=1.0),
                       0.0, 1.0)
    return x * 10.0 ** (target_db[:, None] * frac / 20.0)


def _gate(keep, new, old):
    return torch.where(keep[:, None], new, old)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

class _Draws:
    """Uniforms, Bernoullis, integers and normals on one generator."""

    def __init__(self, gen: torch.Generator, B: int):
        self.gen, self.B, self.device = gen, B, gen.device

    def uniform(self, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(self.B, generator=self.gen, device=self.device)
        lo_t = torch.full((self.B,), lo, device=self.device)
        return torch.maximum(lo_t, u * (hi - lo) + lo)

    def bernoulli(self, p: float) -> torch.Tensor:
        return torch.rand(self.B, generator=self.gen, device=self.device) < p

    def integers(self, high: int) -> torch.Tensor:
        return torch.randint(high, (self.B,), generator=self.gen,
                             device=self.device)

    def normal(self, L: int) -> torch.Tensor:
        return torch.randn(self.B, L, generator=self.gen, device=self.device)


def _draw_torch(d: _Draws, L: int, banks, polarity_p: float) -> TorchModeDraw:
    gain_db, gain_on = d.uniform(-6.0, 6.0), d.bernoulli(0.5)
    shift = (d.uniform(-0.25, 0.25) * L).to(torch.int32)
    shift_on = d.bernoulli(0.25)
    polarity_on = d.bernoulli(polarity_p)
    noise_snr, f_decay = d.uniform(3.0, 30.0), d.uniform(-2.0, 2.0)
    white, noise_on = d.normal(L), d.bernoulli(0.5)
    bg, rir = (None, None, None), (None, None)
    if banks is not None:
        bg = (d.integers(banks.noise.shape[0]), d.uniform(3.0, 30.0),
              d.bernoulli(0.5))
        rir = (d.integers(banks.rir.shape[0]), d.bernoulli(0.25))
    return TorchModeDraw(gain_db, gain_on, shift, shift_on, polarity_on,
                         noise_snr, f_decay, white, noise_on, *bg, *rir)


def _draw_np(d: _Draws, L: int, banks, sample_rate: int) -> NpModeDraw:
    k = torch.randint(4, N_MEMBERS + 1, (d.B,), generator=d.gen,
                      device=d.device)
    scores = torch.rand(d.B, N_MEMBERS, generator=d.gen, device=d.device)
    thr = torch.gather(torch.sort(scores, dim=-1, descending=True).values,
                       -1, (k - 1)[:, None])
    sel = scores >= thr
    bg_idx = bg_snr = rir_idx = None
    if banks is not None:
        bg_idx, bg_snr = d.integers(banks.noise.shape[0]), d.uniform(3.0, 30.0)
    gauss_snr, white = d.uniform(5.0, 40.0), d.normal(L)
    if banks is not None:
        rir_idx = d.integers(banks.rir.shape[0])
    return NpModeDraw(
        sel, bg_idx, bg_snr, gauss_snr, white, rir_idx,
        temperature=d.uniform(10.0, 20.0), humidity=d.uniform(60.0, 80.0),
        distance=d.uniform(0.1, 1.0), gain_db=d.uniform(-6.0, 12.0),
        trans_db=d.uniform(-6.0, 6.0),
        trans_dur=d.uniform(0.1 * sample_rate, 2.0 * sample_rate),
        trans_t0=d.uniform(0.0, float(L)),
        shift=(d.uniform(-0.2, 0.2) * L).to(torch.int32),
        distortion=d.uniform(0.01, 0.2), mask_frac=d.uniform(0.0, 0.2),
        mask_pos=d.uniform(0.0, 1.0))


def draw_time_augment(gen: torch.Generator, n_rows: int, L: int,
                      banks: Optional[AugmentBanks] = None,
                      mode: str = "np", sample_rate: int = 16000,
                      polarity_p: float = 0.5):
    """The random numbers of one :func:`time_augment` call over
    ``n_rows`` rows of ``L`` samples, on ``gen``'s device."""
    d = _Draws(gen, n_rows)
    if mode == "torch":
        return _draw_torch(d, L, banks, polarity_p)
    if mode == "np":
        return _draw_np(d, L, banks, sample_rate)
    raise ValueError(f"unknown time_augment mode: {mode!r}")


# ---------------------------------------------------------------------------
# The two chains
# ---------------------------------------------------------------------------

def _apply_torch(x, p: TorchModeDraw, banks) -> torch.Tensor:
    x = _gate(p.gain_on, _gain_db(x, p.gain_db), x)
    x = _gate(p.shift_on, _roll(x, p.shift), x)
    x = _gate(p.polarity_on, -x, x)
    x = _peak_normalize_too_loud(x)
    noised = _mix_at_snr(x, _colored_noise(p.white, p.f_decay), p.noise_snr)
    x = _gate(p.noise_on, noised, x)
    if banks is not None:
        bg = _mix_noise(x, banks.noise[p.bg_idx], banks.noise_db[p.bg_idx],
                        p.bg_snr)
        x = _gate(p.bg_on, bg, x)
        rir = _compensate_delay(banks.rir[p.rir_idx])
        x = _gate(p.rir_on, _reverberate(x, rir), x)
    return x


def _apply_np(x, p: NpModeDraw, banks, sample_rate: int) -> torch.Tensor:
    sel = p.sel
    if banks is not None:
        bg = _mix_noise(x, banks.noise[p.bg_idx], banks.noise_db[p.bg_idx],
                        p.bg_snr)
        x = _gate(sel[:, 0], bg, x)
    white = p.white / torch.sqrt(torch.mean(p.white ** 2, -1, keepdim=True)
                                 + 1e-12)
    x = _gate(sel[:, 1], _mix_at_snr(x, white, p.gauss_snr), x)
    if banks is not None:
        x = _gate(sel[:, 2], _reverberate(x, banks.rir[p.rir_idx]), x)
    x = _gate(sel[:, 3], _air_absorption(x, p.temperature, p.humidity,
                                         p.distance, sample_rate), x)
    x = _gate(sel[:, 4], _gain_db(x, p.gain_db), x)
    x = _gate(sel[:, 5], _gain_transition(x, p.trans_db, p.trans_t0,
                                          p.trans_dur), x)
    x = _gate(sel[:, 6], -x, x)
    fade = max(int(0.01 * sample_rate), 1)
    x = _gate(sel[:, 7], _shift_fade(x, p.shift, fade), x)
    x = _gate(sel[:, 8], _tanh_distortion(x, p.distortion), x)
    x = _gate(sel[:, 9], _time_mask(x, p.mask_frac, p.mask_pos), x)
    return x


def apply_time_augment(wave: torch.Tensor, draw,
                       banks: Optional[AugmentBanks] = None,
                       sample_rate: int = 16000) -> torch.Tensor:
    """``wave [B, L]`` (or ``[B, n_per, L]``) through the chain of
    ``draw``'s mode with its numbers."""
    shape = wave.shape
    x = wave.reshape(-1, shape[-1])
    if isinstance(draw, TorchModeDraw):
        x = _apply_torch(x, draw, banks)
    else:
        x = _apply_np(x, draw, banks, sample_rate)
    return x.reshape(shape)


def time_augment(wave: torch.Tensor, gen: torch.Generator,
                 banks: Optional[AugmentBanks] = None, mode: str = "np",
                 sample_rate: int = 16000,
                 polarity_p: float = 0.5) -> torch.Tensor:
    """Time-domain augmentation of ``wave [B, L]`` or ``[B, n_per, L]`` on
    its device, the numbers drawn from ``gen``."""
    n_rows = int(np.prod(wave.shape[:-1]))
    draw = draw_time_augment(gen, n_rows, wave.shape[-1], banks, mode,
                             sample_rate, polarity_p)
    return apply_time_augment(wave, draw, banks, sample_rate)
