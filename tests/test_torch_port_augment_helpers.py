"""Shared helpers of the ``test_torch_port_augment_*`` parity tests (no
tests here): a small synthetic noise corpus in the MUSAN / RIRS_NOISES
layout that ``AugmentWav`` globs, its ``augment_options``, and JAX's
draws of the on-device augmentations replayed as the port's draws."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.ops.device_augment import EnvDraw
from speakerverification_tpu_torch.ops.specaugment import (
    MaskDraw,
    SpecAugmentDraw,
)
from speakerverification_tpu_torch.ops.timeaugment import (
    NpModeDraw,
    TorchModeDraw,
)

SR = 8000
SPEC = {"sample_rate": SR, "sentence_len": 0.5}          # 4,000 samples


def write_noise_corpus(root: Path, seed: int = 0) -> dict:
    """Noise, speech and music under ``musan_split/<cat>/<a>/<b>/``, two
    ``noise_vad`` files, two point-source noises and four simulated RIRs
    (shorter and longer than the crop); returns ``augment_options``."""
    rng = np.random.default_rng(seed)
    musan = root / "musan_split"
    for cat, n in (("noise", 3), ("speech", 4), ("music", 2)):
        for i in range(n):
            length = int(rng.integers(2500, 9000))   # some shorter than T
            write_wav(musan / cat / f"src{i % 2}" / f"x{i}" / f"{i}.wav",
                      rng.uniform(-0.5, 0.5, length).astype(np.float32), SR)
    for i in range(2):
        write_wav(root / "noise_vad" / f"v{i}" / f"n{i}.wav",
                  rng.uniform(-0.3, 0.3, 6000).astype(np.float32), SR)
    rirs = root / "RIRS_NOISES"
    for i in range(2):
        write_wav(rirs / "pointsource_noises" / f"p{i}.wav",
                  rng.uniform(-0.4, 0.4, 5000).astype(np.float32), SR)
    for i, length in enumerate((700, 1800, 4000, 5200)):
        t = np.arange(length)
        rir = np.exp(-t / (150.0 * (i + 1))) * rng.uniform(-1, 1, length)
        rir[int(rng.integers(0, 40))] = 1.0          # a direct-path peak
        write_wav(rirs / "simulated_rirs" / f"room{i % 2}" / f"R{i}"
                  / "r.wav", (0.9 * rir / np.abs(rir).max()).astype(
                      np.float32), SR)
    return {
        "augment_paths": {"musan": str(musan),
                          "noise_vad": str(root / "noise_vad"),
                          "rirs": str(rirs)},
        "augment_chain": ["env_corrupt", "time_domain"],
        "noise_proportion": [0.2, 0.1, 0.2, 0.25, 0.25],
        "noise_snr": {"noise": [0, 5], "speech": [3, 20], "music": [5, 15],
                      "noise_vad": [3, 15], "noise_rirs": [3, 15]},
        "noise_samples": {"noise": [1, 1], "speech": [3, 7],
                          "music": [1, 1], "noise_vad": [1, 1],
                          "noise_rirs": [1, 1]},
        "augment_time_domain": {"volume": 4, "speed": [0.95, 1.05],
                                "pitch": [-0.5, 0.5],
                                "proportion": [0.25, 0.25, 0.25]},
    }


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


# ---------------------------------------------------------------------------
# JAX's draws, replayed: the same jax.random calls on the same split keys
# as the JAX functions make, handed to the port's apply functions
# ---------------------------------------------------------------------------

def env_draw(key, n_rows: int, jbanks) -> EnvDraw:
    """``ops/device_augment.py::device_env_corrupt``'s draws."""
    k_type, k_noise, k_snr, k_rir, k_order = jax.random.split(key, 5)
    augtype = jax.random.categorical(
        k_type, jnp.log(jnp.asarray([0.2, 0.4, 0.2, 0.2])), shape=(n_rows,))
    ni = jax.random.randint(k_noise, (n_rows,), 0, jbanks.noise.shape[0])
    snr = jax.random.uniform(k_snr, (n_rows,), minval=jbanks.snr_lo[ni],
                             maxval=jbanks.snr_hi[ni])
    ri = jax.random.randint(k_rir, (n_rows,), 0, jbanks.rir.shape[0])
    order = jax.random.bernoulli(k_order, 0.5, (n_rows,))
    return EnvDraw(t(augtype, torch.int64), t(ni, torch.int64), t(snr),
                   t(ri, torch.int64), t(order))


def _mask_draw(key, B, axis_len, n_mask, width) -> MaskDraw:
    k_len, k_pos = jax.random.split(key)
    w0, w1 = width
    w1 = max(w1, w0 + 1)
    length = jax.random.randint(k_len, (B, n_mask, 1), w0, w1)
    pos = jax.random.randint(k_pos, (B, n_mask, 1), 0,
                             jnp.maximum(1, axis_len - jnp.max(length)))
    return MaskDraw(t(length, torch.int64), t(pos, torch.int64))


def spec_draw(key, shape, cfg) -> SpecAugmentDraw:
    """``ops/specaugment.py::spec_augment``'s draws."""
    B, T, F = shape
    k_warp, k_freq, k_time = jax.random.split(key, 3)
    warp = None
    window = cfg.time_warp_window
    if cfg.time_warp and T - window > window:
        k_c, k_w = jax.random.split(k_warp)
        c = jax.random.randint(k_c, (), window, T - window)
        w = jax.random.randint(k_w, (), c - window, c + window) + 1
        warp = (t(c, torch.int64), t(w, torch.int64))
    time = _mask_draw(k_time, B, T, cfg.n_time_mask,
                      cfg.time_mask_width) if cfg.time_mask else None
    freq = _mask_draw(k_freq, B, F, cfg.n_freq_mask,
                      cfg.freq_mask_width) if cfg.freq_mask else None
    return SpecAugmentDraw(warp, time, freq)


def _u(key, B, lo, hi):
    return t(jax.random.uniform(key, (B,), minval=lo, maxval=hi))


def _bern(key, p, B):
    return t(jax.random.bernoulli(key, p, (B,)))


def time_draw_torch(key, B, L, jbanks, polarity_p=0.5) -> TorchModeDraw:
    """``ops/timeaugment.py::_time_augment_torch``'s draws."""
    ks = jax.random.split(key, 16)
    bank = (None,) * 5
    if jbanks is not None:
        bank = (t(jax.random.randint(ks[9], (B,), 0, jbanks.noise.shape[0]),
                  torch.int64),
                _u(ks[10], B, jnp.full((B,), 3.0), jnp.full((B,), 30.0)),
                _bern(ks[11], 0.5, B),
                t(jax.random.randint(ks[12], (B,), 0, jbanks.rir.shape[0]),
                  torch.int64),
                _bern(ks[13], 0.25, B))
    frac = jax.random.uniform(ks[2], (B,), minval=-0.25, maxval=0.25)
    return TorchModeDraw(
        _u(ks[0], B, -6.0, 6.0), _bern(ks[1], 0.5, B),
        t((frac * L).astype(jnp.int32)), _bern(ks[3], 0.25, B),
        _bern(ks[4], polarity_p, B), _u(ks[5], B, 3.0, 30.0),
        _u(ks[6], B, -2.0, 2.0), t(jax.random.normal(ks[7], (B, L))),
        _bern(ks[8], 0.5, B), *bank)


def time_draw_np(key, B, L, jbanks, sample_rate) -> NpModeDraw:
    """``ops/timeaugment.py::_time_augment_np``'s draws."""
    ks = jax.random.split(key, 24)
    k = jax.random.randint(ks[0], (B,), 4, 11)
    scores = jax.random.uniform(ks[1], (B, 10))
    thr = jnp.take_along_axis(jnp.sort(scores, axis=-1)[:, ::-1],
                              (k - 1)[:, None], axis=-1)
    bg_idx = bg_snr = rir_idx = None
    if jbanks is not None:
        bg_idx = t(jax.random.randint(ks[2], (B,), 0, jbanks.noise.shape[0]),
                   torch.int64)
        bg_snr = _u(ks[3], B, jnp.full((B,), 3.0), jnp.full((B,), 30.0))
        rir_idx = t(jax.random.randint(ks[6], (B,), 0, jbanks.rir.shape[0]),
                    torch.int64)
    shift = jax.random.uniform(ks[14], (B,), minval=-0.2, maxval=0.2)
    return NpModeDraw(
        sel=t(scores >= thr), bg_idx=bg_idx, bg_snr=bg_snr,
        gauss_snr=_u(ks[4], B, 5.0, 40.0),
        white=t(jax.random.normal(ks[5], (B, L))), rir_idx=rir_idx,
        temperature=_u(ks[7], B, 10.0, 20.0),
        humidity=_u(ks[8], B, 60.0, 80.0), distance=_u(ks[9], B, 0.1, 1.0),
        gain_db=_u(ks[10], B, -6.0, 12.0), trans_db=_u(ks[11], B, -6.0, 6.0),
        trans_dur=_u(ks[12], B, 0.1 * sample_rate, 2.0 * sample_rate),
        trans_t0=_u(ks[13], B, 0.0, float(L)),
        shift=t((shift * L).astype(jnp.int32)),
        distortion=_u(ks[15], B, 0.01, 0.2),
        mask_frac=_u(ks[16], B, 0.0, 0.2), mask_pos=_u(ks[17], B, 0.0, 1.0))
