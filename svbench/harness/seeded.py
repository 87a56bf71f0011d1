"""Weights and inputs made from ``--seed``, in a few large calls on the
run's device, so that the same seed gives the same tensors.

The weights are drawn for the reference model, whose parameter names are
the program's (flax scope names), and the same tensors are loaded into
the program: nothing the program derives from them reaches the
reference."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

__all__ = ["generator", "seeded_state", "int16_audio", "fixed_gaps"]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number >= 0. The
    seed is hashed to 63 bits first (``numpy.random.SeedSequence``), so
    that seeds differing only past the 32nd bit differ in the low bits a
    CPU generator keeps."""
    state = np.random.SeedSequence(int(seed)).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & (2 ** 63 - 1))
    return gen


def seeded_state(model: nn.Module, seed: int) -> dict:
    """A state dict for ``model`` (which lives on the device the weights
    are made on):

    - conv and linear weights ~ N(0, 1/fan_in), their biases ~ N(0, 0.02²);
    - a head's ``[classes, dim]`` matrix ~ N(0, 2/(classes + dim));
    - BatchNorm: scale U(0.8, 1.2), shift N(0, 0.1²), running mean
      N(0, 0.1²), running variance U(0.5, 1.5), so that eval-mode
      normalization is not the identity;
    - every other tensor (the sinc band edges, AFMS offsets, the norms'
      affines, counters) keeps the value the reference's constructor
      gave it.

    Two draws in all: one normal and one uniform vector, sliced."""
    device = next(model.parameters()).device
    normal, uniform = [], []     # (key, shape, scale, shift)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for mname, m in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal.append((pre + "weight", m.weight.shape, fan_in ** -0.5, 0.0))
            if m.bias is not None:
                normal.append((pre + "bias", m.bias.shape, 0.02, 0.0))
        elif isinstance(m, nn.BatchNorm1d):
            n = (m.num_features,)
            uniform.append((pre + "weight", n, 0.4, 0.8))
            normal.append((pre + "bias", n, 0.1, 0.0))
            normal.append((pre + "running_mean", n, 0.1, 0.0))
            uniform.append((pre + "running_var", n, 1.0, 0.5))
        elif pre.startswith("loss.") and hasattr(m, "weight") and \
                getattr(m, "weight") is not None and m.weight.dim() == 2:
            c, d = m.weight.shape
            normal.append((pre + "weight", m.weight.shape,
                           (2.0 / (c + d)) ** 0.5, 0.0))
    gen = generator(seed, device)
    for draws, fn in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(int(np.prod(s)) for _, s, _, _ in draws)
        flat = fn(total, generator=gen, device=device)
        at = 0
        for key, shape, scale, shift in draws:
            n = int(np.prod(shape))
            state[key] = (flat[at:at + n].view(shape) * scale + shift)
            at += n
    return state


def int16_audio(rng: np.random.Generator, n_samples: int,
                sample_rate: int) -> np.ndarray:
    """A speech-like test signal as 16-bit PCM read back to float32
    (exactly on the 1/32768 grid, so the int16 wire is lossless): five
    harmonic partials of a seeded pitch (powers of one complex phasor,
    in float32) under a syllable-rate envelope, plus noise."""
    t = np.arange(n_samples, dtype=np.float32) / np.float32(sample_rate)
    f0 = rng.uniform(90.0, 250.0)
    w = np.float32(2 * np.pi * f0) * t
    z = np.empty(n_samples, np.complex64)
    z.real, z.imag = np.cos(w), np.sin(w)
    sig = np.zeros(n_samples, np.float32)
    zh = np.ones(n_samples, np.complex64)
    for h in range(1, 6):
        zh *= z
        amp = rng.uniform(0.2, 1.0) / h
        phase = np.complex64(np.exp(1j * rng.uniform(0, 2 * np.pi)))
        sig += np.float32(amp) * (zh * phase).imag
    env = 0.55 + 0.45 * np.sin(np.float32(2 * np.pi * rng.uniform(2.0, 6.0))
                               * t + np.float32(rng.uniform(0, 2 * np.pi)))
    sig = sig * env + 0.05 * rng.standard_normal(n_samples, np.float32)
    sig *= 0.5 / np.max(np.abs(sig))
    return (np.round(sig * 32767.0).astype(np.int16).astype(np.float32)
            / 32768.0)


def fixed_gaps(rng: np.random.Generator, rate: float, count: int,
               ) -> np.ndarray:
    """``count`` exponential inter-arrival gaps at ``rate`` per second
    whose values are the same for every seed (the distribution's
    quantiles at ``(i + 1/2) / count``), in an order the seed draws:
    Poisson arrivals with the same work in every run."""
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / rate
    return gaps[rng.permutation(count)]
