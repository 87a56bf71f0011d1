"""GEMM-form audio frontend: pre-emphasis + windowed real DFT + mel
(+ dB + DCT for MFCC).

Port of ``speakerverification_tpu/ops/frontend.py``. The constants (mel
filterbank, window, DFT bases, frame indices) are the same numpy code;
the ops run in PyTorch:

    frames  = unfold(pad_reflect(pre_emphasis(x)))        # [B, F, n_fft]
    power   = (frames @ C)**2 + (frames @ S)**2           # windowed real DFT
    mel     = power @ M                                   # mel projection
    mfcc    = power_to_db(mel) @ D                        # DCT-II

``spectrogram`` stops at the power spectrum.

This module is the plain path (``frontend_backend: xla``). The
hand-written CUDA kernel for the mel pipeline is in
``ops/mel_frontend.py``; :func:`select_mel_frontend` picks between them.
``mfcc`` and ``spectrogram`` always run here, as the JAX package runs
them outside its Pallas kernel.
Numerics follow the torchaudio-slaney convention (center=True reflect
padding, periodic window padded to n_fft, power spectrum, slaney mel
scale and filterbank normalization).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FrontendConfig",
    "pre_emphasis",
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "dft_matrices",
    "dct_matrix",
    "power_to_db",
    "window_rows",
    "frame_indices",
    "reflect_pad",
    "mel_constants",
    "make_frontend",
    "select_mel_frontend",
    "use_kernel",
]


# ---------------------------------------------------------------------------
# NumPy-side constant construction (copied from the JAX package).
# ---------------------------------------------------------------------------

def hz_to_mel(freq, mel_scale: str = "slaney"):
    """Hz → mel. ``slaney`` (librosa/torchaudio default here) or ``htk``."""
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
                    mels)


def mel_to_hz(mels, mel_scale: str = "slaney"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   mel_scale: str = "slaney", norm: Optional[str] = "slaney",
                   ) -> np.ndarray:
    """Triangular mel filterbank ``[n_freqs, n_mels]`` (torchaudio layout)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)

    m_pts = np.linspace(hz_to_mel(fmin, mel_scale), hz_to_mel(fmax, mel_scale),
                        n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)

    f_diff = np.diff(f_pts)                               # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]          # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def _window(name: str, win_length: int, periodic: bool = True) -> np.ndarray:
    """Analysis window; periodic (fftbins) to match torch.*_window defaults."""
    n = win_length + 1 if periodic else win_length
    k = np.arange(n, dtype=np.float64)
    if name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))
    elif name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
    elif name in ("rect", "rectangular", "ones", "boxcar"):
        w = np.ones(n)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
             + 0.08 * np.cos(4 * np.pi * k / (n - 1)))
    else:
        raise ValueError(f"unknown window {name!r}")
    return w[:win_length].astype(np.float64) if periodic else w.astype(np.float64)


def dft_matrices(n_fft: int, win_length: int, window: str = "hamming",
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases ``C, S`` of shape ``[n_fft, n_fft//2 + 1]``.

    The ``win_length``-sample window is centered inside the ``n_fft`` frame
    (as torch.stft does when ``win_length < n_fft``) and folded into the
    cosine/sine bases.
    """
    w = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win_length) // 2
    w[left:left + win_length] = _window(window, win_length)

    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(angle) * w[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * w[:, None]).astype(np.float32)
    return cos_b, sin_b


def dct_matrix(n_mfcc: int, n_mels: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II basis ``[n_mels, n_mfcc]`` (torchaudio ``create_dct`` layout)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        dct[:, 0] *= 1.0 / math.sqrt(2.0)
        dct *= math.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return dct.astype(np.float32)


def window_rows(cfg: "FrontendConfig") -> tuple[int, int]:
    """Rows ``[lo, hi)`` of the :func:`dft_matrices` bases that the window
    covers; every other row is zero."""
    lo = (cfg.n_fft - cfg.win_length) // 2
    return lo, lo + cfg.win_length


def frame_indices(num_samples_padded: int, n_fft: int, hop_length: int) -> np.ndarray:
    n_frames = 1 + (num_samples_padded - n_fft) // hop_length
    return (np.arange(n_frames)[:, None] * hop_length
            + np.arange(n_fft)[None, :]).astype(np.int32)


# ---------------------------------------------------------------------------
# Tensor ops.
# ---------------------------------------------------------------------------

def pre_emphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """``y[t] = x[t] - coef * x[t-1]`` with left reflect padding, so
    ``y[0] = x[0] - coef * x[1]`` (not zero-padded)."""
    prev = torch.cat([x[..., 1:2], x[..., :-1]], dim=-1)
    return x - coef * prev


def power_to_db(power: torch.Tensor, top_db: Optional[float] = 80.0,
                amin: float = 1e-10, ref: float = 1.0) -> torch.Tensor:
    """Power → dB, clamped to ``top_db`` below the maximum of each row of
    the leading axis (all other axes together), torchaudio's semantics."""
    db = 10.0 * torch.log10(torch.clamp(power, min=amin))
    db = db - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        max_db = db.reshape(db.shape[0], -1).amax(dim=-1)
        floor = (max_db - top_db).reshape((-1,) + (1,) * (db.dim() - 1))
        db = torch.maximum(db, floor)
    return db


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of ``[B, T]`` by ``pad`` on each side."""
    return F.pad(x.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Defaults follow the reference's mel factory (fmin 0, fmax sr/2);
    ``from_hparams`` keys the band edges on the feature type."""
    sample_rate: int = 8000
    n_fft: int = 512
    win_length: int = 200
    hop_length: int = 80
    n_mels: int = 80
    n_mfcc: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None
    window: str = "hamming"
    mel_scale: str = "slaney"
    mel_norm: Optional[str] = "slaney"
    power: float = 2.0
    center: bool = True
    pre_emphasis: Optional[float] = 0.97
    top_db: Optional[float] = 80.0

    @classmethod
    def from_hparams(cls, hparams: dict,
                     feature_type: str = "melspectrogram") -> "FrontendConfig":
        """Build from the YAML schema keys. Top-level ``sample_rate`` wins
        over ``audio_spec``'s; win/hop default from ``audio_spec``'s
        win_len/hop_len seconds; fmin/fmax defaults depend on the feature
        type (mfcc: 10/4000, otherwise 0/None); explicit keys win."""
        spec = hparams.get("audio_spec", {}) or {}
        sr = int(hparams.get("sample_rate", spec.get("sample_rate", 8000)))
        if feature_type == "mfcc":
            default_fmin, default_fmax = 10.0, 4000.0
        else:
            default_fmin, default_fmax = 0.0, None  # None → sr/2 in the bank
        return cls(
            sample_rate=sr,
            n_fft=int(hparams.get("n_fft", 512)),
            win_length=int(hparams.get("win_length",
                                       round(spec.get("win_len", 0.025)
                                             * sr))),
            hop_length=int(hparams.get("hop_length",
                                       round(spec.get("hop_len", 0.01)
                                             * sr))),
            n_mels=int(hparams.get("n_mels", 80)),
            n_mfcc=int(hparams.get("n_mfcc", 80)),
            fmin=float(hparams.get("fmin", default_fmin)),
            fmax=hparams.get("fmax", default_fmax),
            pre_emphasis=0.97 if hparams.get("pre_emphasis", True) else None,
        )


@functools.lru_cache(maxsize=16)
def _constants_np(cfg: FrontendConfig):
    cos_b, sin_b = dft_matrices(cfg.n_fft, cfg.win_length, cfg.window)
    cs = np.ascontiguousarray(np.concatenate([cos_b, sin_b], axis=1))
    fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate,
                        cfg.fmin, cfg.fmax, cfg.mel_scale, cfg.mel_norm)
    return cs, fb


_device_constants: dict = {}


def mel_constants(cfg: FrontendConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``cs [n_fft, 2K]`` (the windowed cos bins, then the sin bins) and
    ``fb [K, n_mels]`` on ``device``, built once per (config, device)."""
    key = (cfg, str(torch.device(device)))
    if key not in _device_constants:
        cs, fb = _constants_np(cfg)
        # ordinary tensors even when first asked for under inference
        # mode: torch.export takes them in as constants, and refuses
        # inference tensors
        with torch.inference_mode(False):
            _device_constants[key] = (torch.as_tensor(cs, device=device),
                                      torch.as_tensor(fb, device=device))
    return _device_constants[key]


_device_dct: dict = {}


def _dct(cfg: FrontendConfig, device) -> torch.Tensor:
    key = (cfg, str(torch.device(device)))
    if key not in _device_dct:
        with torch.inference_mode(False):
            _device_dct[key] = torch.as_tensor(
                dct_matrix(cfg.n_mfcc, cfg.n_mels), device=device)
    return _device_dct[key]


def make_frontend(cfg: FrontendConfig = FrontendConfig(),
                  feature_type: str = "melspectrogram",
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the plain ``wave [..., T] -> features [..., frames, D]``.

    ``feature_type``: ``melspectrogram`` (D = n_mels), ``mfcc`` (D =
    n_mfcc; ``top_db`` clamps each row of the flattened ``[-1, T]``
    waves, so each crop on its own), ``spectrogram`` (the power
    spectrum, D = n_fft // 2 + 1) or ``raw`` (passthrough). For the
    mfcc factory's band edges (10/4000 Hz) build ``cfg`` with
    ``FrontendConfig.from_hparams(..., "mfcc")``.
    """
    if feature_type == "raw":
        return lambda x: x
    if feature_type not in ("melspectrogram", "mfcc", "spectrogram"):
        raise ValueError(f"unknown feature_type {feature_type!r}")

    def frontend(x: torch.Tensor) -> torch.Tensor:
        batch_shape = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if cfg.pre_emphasis is not None:
            x = pre_emphasis(x, cfg.pre_emphasis)
        if cfg.center:
            x = reflect_pad(x, cfg.n_fft // 2)
        frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)    # [B, F, n_fft]
        cs, fb = mel_constants(cfg, x.device)
        proj = frames @ cs                                   # [B, F, 2K]
        re, im = proj.chunk(2, dim=-1)
        power = re * re + im * im                            # [B, F, K]
        if cfg.power != 2.0:
            power = torch.pow(power.clamp_min(0.0), cfg.power / 2.0)
        if feature_type == "spectrogram":
            out = power
        else:
            out = power @ fb
            if feature_type == "mfcc":
                out = power_to_db(out, cfg.top_db) @ _dct(cfg, x.device)
        return out.reshape(batch_shape + out.shape[-2:])

    return frontend


def use_kernel(backend: str, x: torch.Tensor) -> bool:
    """``'pallas'`` selects the port's hand-written kernel, ``'xla'`` the
    plain PyTorch path, ``'auto'`` the kernel for a CUDA tensor."""
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"backend must be 'auto', 'xla' or 'pallas', got {backend!r}")
    return backend == "pallas" or (backend == "auto" and x.is_cuda)


def select_mel_frontend(cfg: FrontendConfig, feature_type: str,
                        backend: str, x: torch.Tensor):
    """The frontend a model runs on ``x``: the mel kernel's pipeline
    (``ops/mel_frontend.py``) where ``backend`` selects it, else the
    plain path."""
    if feature_type == "melspectrogram" and use_kernel(backend, x):
        from speakerverification_tpu_torch.ops.mel_frontend import (
            make_mel_frontend,
        )
        return make_mel_frontend(cfg)
    return make_frontend(cfg, feature_type)
