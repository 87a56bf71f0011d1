"""Batched env_corrupt on the device (port of ``ops/device_augment.py``).

The host path (``data/augment.py``) corrupts one crop at a time on the
loader's threads. Here noise crops and RIRs are loaded once into banks
that live on the device (:func:`build_banks`, host numpy, refreshed per
epoch by the trainer), and :func:`device_env_corrupt` corrupts a whole
batch in one pass of tensor operations: per row, rev / noise / both /
none at .2/.4/.2/.2, the SNR-scaled mix of one bank clip (the host path's
gain formula) and the full FFT convolution with one bank RIR cut to the
crop. Every branch is computed for every row, then selected.

It differs from the host path as the JAX function does: one noise clip
per mix, drawn from the bank, not 1..k files from the corpus.

The random numbers are drawn apart from the arithmetic:
:func:`draw_env_corrupt` takes them from a ``torch.Generator`` on the
banks' device, and :func:`apply_env_corrupt` is a deterministic function
of the wave, the draw and the banks.

The FFT convolution pads to the next power of two at or above
``L + Lr − 1`` (32,768 for two 16,000-sample signals, where the JAX
function's 31,999 = 11 · 2,909 is a slow size for cuFFT); any length
from ``L + Lr − 1`` on gives the same first ``L`` samples.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["AugmentBanks", "EnvDraw", "build_banks", "banks_from_arrays",
           "draw_env_corrupt", "apply_env_corrupt", "device_env_corrupt"]

# rev / noise / both / none
_ENV_PROBS = (0.2, 0.4, 0.2, 0.2)


class AugmentBanks(NamedTuple):
    noise: torch.Tensor       # [N, L] crops
    noise_db: torch.Tensor    # [N] 10·log10(mean² + 1e-4)
    snr_lo: torch.Tensor      # [N] each clip's category's SNR range
    snr_hi: torch.Tensor      # [N]
    rir: torch.Tensor         # [R, Lr] energy-normalized RIRs


class EnvDraw(NamedTuple):
    augtype: torch.Tensor     # [B] 0 rev, 1 noise, 2 both, 3 none
    noise_idx: torch.Tensor   # [B]
    snr: torch.Tensor         # [B] dB
    rir_idx: torch.Tensor     # [B]
    rev_first: torch.Tensor   # [B] bool: 'both' reverberates first


def banks_from_arrays(banks, device=None) -> AugmentBanks:
    """``AugmentBanks`` on ``device`` (default CUDA) from any object with
    the fields ``noise``, ``noise_db``, ``snr_lo``, ``snr_hi`` and
    ``rir`` as arrays: numpy arrays, or the JAX package's banks read
    through ``numpy.asarray``."""
    from speakerverification_tpu_torch.inference import resolve_device
    device = resolve_device(device)
    return AugmentBanks(*(
        torch.from_numpy(np.array(getattr(banks, f), np.float32)).to(device)
        for f in AugmentBanks._fields))


def build_banks(augmentor, n_noise: int = 256, n_rir: int = 64,
                rng: Optional[np.random.Generator] = None,
                device=None) -> AugmentBanks:
    """Noise and RIR banks sampled through a host ``AugmentWav``: clips
    random-cropped to ``max_audio`` from categories drawn at
    ``noise_proportion``, each with its category's SNR range; RIRs
    energy-normalized and cut or zero-padded to ``max_audio`` taps (the
    output's first ``max_audio`` samples read no later tap). The draws
    are the JAX function's, so the same ``rng`` gives the same banks."""
    from speakerverification_tpu_torch.data.audio import load_wav
    from speakerverification_tpu_torch.data.augment import NOISE_CATEGORIES

    rng = rng or np.random.default_rng()
    spec = augmentor.spec
    L = augmentor.max_audio

    cats = [c for c in NOISE_CATEGORIES if augmentor.noiselist.get(c)]
    if not cats:
        raise ValueError("augmentor has no noise files")
    probs = np.array([augmentor.noise_proportion[NOISE_CATEGORIES.index(c)]
                      for c in cats])
    probs = probs / probs.sum()

    noise = np.zeros((n_noise, L), np.float32)
    lo = np.zeros(n_noise, np.float32)
    hi = np.zeros(n_noise, np.float32)
    for i in range(n_noise):
        cat = str(rng.choice(cats, p=probs))
        files = augmentor.noiselist[cat]
        f = files[int(rng.integers(len(files)))]
        noise[i] = load_wav(f, spec, evalmode=False, rng=rng)[0]
        lo[i], hi[i] = augmentor.noise_snr[cat]
    noise_db = 10.0 * np.log10(np.mean(noise ** 2, axis=1) + 1e-4)

    if not augmentor.reverberation_files:
        raise ValueError("augmentor has no RIR files")
    rir = np.zeros((n_rir, L), np.float32)
    for i in range(n_rir):
        f = augmentor.reverberation_files[
            int(rng.integers(len(augmentor.reverberation_files)))]
        r = load_wav(f, spec, load_all=True)[0]
        r = r / np.sqrt(np.sum(r ** 2) + 1e-12)
        rir[i, :min(len(r), L)] = r[:L]

    return banks_from_arrays(AugmentBanks(noise, noise_db, lo, hi, rir),
                             device)


def _mix_noise(wave, noise, noise_db, snr):
    """``wave + gain · noise`` at ``snr`` dB over the wave's own dB."""
    clean_db = 10.0 * torch.log10(torch.mean(wave ** 2, dim=-1) + 1e-4)
    gain = torch.sqrt(10.0 ** ((clean_db - noise_db - snr) / 10.0))
    return wave + gain[:, None] * noise


def _reverberate(wave, rir):
    """The full convolution of each row of ``wave [B, L]`` with its RIR
    ``rir [B, Lr]``, cut to ``L`` samples."""
    L = wave.shape[-1]
    n = 1 << (L + rir.shape[-1] - 2).bit_length()      # ≥ L + Lr − 1
    wf = torch.fft.rfft(wave, n=n)
    rf = torch.fft.rfft(rir, n=n)
    return torch.fft.irfft(wf * rf, n=n)[..., :L].to(wave.dtype)


def draw_env_corrupt(gen: torch.Generator, n_rows: int,
                     banks: AugmentBanks) -> EnvDraw:
    """The random numbers of one :func:`device_env_corrupt` call over
    ``n_rows`` rows, drawn on ``gen``'s device."""
    device = gen.device
    probs = torch.tensor(_ENV_PROBS, device=device)
    augtype = torch.multinomial(probs.expand(n_rows, 4), 1, replacement=True,
                                generator=gen)[:, 0]
    ni = torch.randint(banks.noise.shape[0], (n_rows,), generator=gen,
                       device=device)
    u = torch.rand(n_rows, generator=gen, device=device)
    lo, hi = banks.snr_lo[ni], banks.snr_hi[ni]
    snr = torch.maximum(lo, u * (hi - lo) + lo)
    ri = torch.randint(banks.rir.shape[0], (n_rows,), generator=gen,
                       device=device)
    rev_first = torch.rand(n_rows, generator=gen, device=device) < 0.5
    return EnvDraw(augtype, ni, snr, ri, rev_first)


def apply_env_corrupt(wave: torch.Tensor, draw: EnvDraw,
                      banks: AugmentBanks) -> torch.Tensor:
    """``wave [B, L]`` (or ``[B, n_per, L]``) corrupted as ``draw`` says."""
    shape = wave.shape
    x = wave.reshape(-1, shape[-1])
    noise = banks.noise[draw.noise_idx]
    ndb = banks.noise_db[draw.noise_idx]
    rir = banks.rir[draw.rir_idx]

    rev = _reverberate(x, rir)
    noised = _mix_noise(x, noise, ndb, draw.snr)
    # 'both': the noise gain reads its own input's dB, as the host chain
    rev_then_noise = _mix_noise(rev, noise, ndb, draw.snr)
    noise_then_rev = _reverberate(noised, rir)
    both = torch.where(draw.rev_first[:, None], rev_then_noise,
                       noise_then_rev)
    t = draw.augtype[:, None]
    out = torch.where(t == 0, rev, x)
    out = torch.where(t == 1, noised, out)
    out = torch.where(t == 2, both, out)
    return out.reshape(shape)


def device_env_corrupt(wave: torch.Tensor, banks: AugmentBanks,
                       gen: torch.Generator) -> torch.Tensor:
    """Per-row rev / noise / both / none of ``wave [B, L]`` or ``[B, n_per,
    L]`` on the banks' device, its numbers drawn from ``gen``."""
    n_rows = int(np.prod(wave.shape[:-1]))
    return apply_env_corrupt(wave, draw_env_corrupt(gen, n_rows, banks),
                             banks)
