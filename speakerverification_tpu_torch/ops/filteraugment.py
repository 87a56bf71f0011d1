"""FilterAugment suite (port of ``ops/filteraugment.py``): feature-domain
augmentations on ``[B, T, F]``.

The reference's FilterAugment.py:11-224 (frame_shift, mixup, time_mask,
feature_transformation, filt_aug_prototype, filt_aug, freq_mask,
add_noise from the FilterAugSED lineage), on the frontend's
channels-last layout: "time" ops act on axis 1, "frequency" ops on axis
2. Each op takes a ``torch.Generator`` where the JAX op takes a key.
jax.random's stream cannot be reproduced, so each op is its draws (the
same distributions as JAX's) followed by a deterministic core that takes
the draws as arguments (``frame_shift_apply``, ``mixup_apply``,
``time_mask_apply``, ``filt_aug_apply``, ``filt_aug_prototype_apply``,
``freq_mask_apply``, ``add_noise_apply``); fed the same draws, a core
gives JAX's output. Draws come from the generator's device and move to
the features'.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["frame_shift", "mixup", "time_mask", "filt_aug",
           "filt_aug_prototype", "freq_mask", "add_noise",
           "feature_transformation", "frame_shift_apply", "mixup_apply",
           "time_mask_apply", "filt_aug_apply", "filt_aug_prototype_apply",
           "freq_mask_apply", "add_noise_apply", "draw_beta"]


def _randint(gen: torch.Generator, low: int, high: int, shape=()):
    return torch.randint(low, high, shape, generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


# ----------------------------------------------------------------------
# frame_shift
# ----------------------------------------------------------------------
def frame_shift_apply(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Roll each example along time by its integer shift."""
    B, T, F = x.shape
    shifts = torch.as_tensor(shifts, device=x.device).long()
    idx = (torch.arange(T, device=x.device)[None, :] - shifts[:, None]) % T
    return torch.gather(x, 1, idx[:, :, None].expand(B, T, F))


def frame_shift(gen: torch.Generator, x: torch.Tensor,
                sigma: float = 90.0) -> torch.Tensor:
    """Per-example circular time shift, shift = int(gauss(0, sigma))
    (FilterAugment.py:11-29; int() truncates toward zero)."""
    z = torch.randn(x.shape[0], generator=gen, device=gen.device)
    return frame_shift_apply(x, (z * sigma).to(torch.int32))


# ----------------------------------------------------------------------
# mixup
# ----------------------------------------------------------------------
def _gamma_log(gen: torch.Generator, a: float, n: int) -> torch.Tensor:
    """``log`` of ``n`` Gamma(a, 1) draws, float64 (Marsaglia and Tsang;
    ``a < 1`` through ``Gamma(a + 1) * U^(1/a)``, in logs so that small
    shapes do not underflow)."""
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float64, device=gen.device)
    todo = torch.arange(n, device=gen.device)
    while todo.numel():
        m = todo.numel()
        z = torch.randn(m, generator=gen, device=gen.device,
                        dtype=torch.float64)
        u = torch.rand(m, generator=gen, device=gen.device,
                       dtype=torch.float64)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = math.log(d) + torch.log(v[ok])
        todo = todo[~ok]
    if boost:
        u = torch.rand(n, generator=gen, device=gen.device,
                       dtype=torch.float64)
        out = out + torch.log(u) / a
    return out


def draw_beta(gen: torch.Generator, alpha: float, beta: float,
              n: int = 1) -> torch.Tensor:
    """``n`` Beta(alpha, beta) draws (float32) from two Gamma draws."""
    la, lb = _gamma_log(gen, alpha, n), _gamma_log(gen, beta, n)
    return torch.sigmoid(la - lb).float()


def mixup_apply(x: torch.Tensor, perm: torch.Tensor, c, label=None,
                mixup_label_type: str = "soft"):
    """``c x + (1 - c) x[perm]``, and the mixed labels when given."""
    perm = torch.as_tensor(perm, device=x.device).long()
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    mixed = c * x + (1 - c) * x[perm]
    if label is None:
        return mixed
    if mixup_label_type == "soft":
        mixed_label = torch.clamp(c * label + (1 - c) * label[perm], 0, 1)
    else:
        mixed_label = torch.clamp(label + label[perm], 0, 1)
    return mixed, mixed_label


def mixup(gen: torch.Generator, x: torch.Tensor, label=None,
          alpha: float = 0.2, beta: float = 0.2,
          mixup_label_type: str = "soft", permutation=None, c=None):
    """Beta-mix the features with a random batch permutation
    (FilterAugment.py:32-61). ``permutation`` and ``c`` may be given,
    as the reference allows."""
    perm = (torch.randperm(x.shape[0], generator=gen, device=gen.device)
            if permutation is None else permutation)
    if c is None:
        c = draw_beta(gen, alpha, beta)[0]
        if mixup_label_type == "hard":
            c = c * 0.4 + 0.3
    return mixup_apply(x, perm, c, label, mixup_label_type)


# ----------------------------------------------------------------------
# time_mask
# ----------------------------------------------------------------------
def time_mask_apply(x: torch.Tensor, width, start) -> torch.Tensor:
    """Zero the time rows ``[start, start + width)`` of every example."""
    t = torch.arange(x.shape[1], device=x.device)
    width = torch.as_tensor(width, device=x.device)
    start = torch.as_tensor(start, device=x.device)
    mask = (t >= start) & (t < start + width)
    return torch.where(mask[None, :, None], torch.zeros_like(x), x)


def time_mask(gen: torch.Generator, x: torch.Tensor,
              mask_ratios: Tuple[int, int] = (10, 20)) -> torch.Tensor:
    """Zero ONE time interval, shared across the batch: width in
    [T/ratios[1], T/ratios[0]), start in [0, T - width)
    (FilterAugment.py:64-80)."""
    T = x.shape[1]
    lo, hi = T // mask_ratios[1], T // mask_ratios[0]
    width = int(_randint(gen, lo, max(hi, lo + 1)))
    start = int(_randint(gen, 0, max(T - width, 1)))
    return time_mask_apply(x, width, start)


# ----------------------------------------------------------------------
# FilterAugment
# ----------------------------------------------------------------------
def _band_gain_filter(x: torch.Tensor, n, interior: torch.Tensor,
                      gains: torch.Tensor, linear_db: bool) -> torch.Tensor:
    """Multiply ``x`` by a per-example piecewise band filter.

    ``interior``: ``[n_max - 1]`` sorted absolute interior boundaries
    (those at positions >= n - 1 pinned to F, so that the trailing bands
    are empty). ``gains``: ``[B, G]`` per band: dB when ``linear_db``
    (interpolated between consecutive entries inside each band,
    torch.linspace's endpoint semantics, then 10**(./20)), amplitudes
    otherwise (a step fill)."""
    B, T, F = x.shape
    dev = x.device
    interior = interior.to(dev)
    gains = gains.to(dev)
    bounds = torch.cat([interior.new_zeros(1), interior,
                        interior.new_full((1,), F)])
    f = torch.arange(F, device=dev)
    # the band owning bin f: the number of interior boundaries <= f (the
    # LAST band starting at or before f, as the reference's sequential
    # in-place fills let a later band overwrite a shared boundary)
    band_idx = (f[:, None] >= interior[None, :]).sum(-1)
    g0 = gains[:, band_idx]                                    # [B, F]
    if linear_db:
        g1 = gains[:, torch.clamp(band_idx + 1, max=gains.shape[1] - 1)]
        lo = bounds[band_idx].float()
        hi = bounds[band_idx + 1].float()
        k = f.float() - lo
        m1 = torch.clamp(hi - lo - 1.0, min=1.0)    # linspace(m)==a at m==1
        amp = 10.0 ** ((g0 + (g1 - g0) * k[None, :] / m1[None, :]) / 20.0)
    else:
        amp = g0
    if int(n) <= 1:
        amp = torch.ones_like(amp)
    return x * amp[:, None, :].to(x.dtype)


def filt_aug_apply(x: torch.Tensor, n: int, raw: torch.Tensor,
                   g_db: torch.Tensor, min_bw: int = 6,
                   filter_type: str = "linear") -> torch.Tensor:
    """The updated FilterAugment on given draws: ``n`` bands, ``raw``
    ``[n_max - 1]`` integer boundary draws (the first ``n - 1`` real) and
    the per-band gains ``g_db`` in dB (``[B, n_max]`` step, ``[B,
    n_max + 1]`` linear)."""
    F = x.shape[2]
    n = int(n)
    raw = torch.as_tensor(raw).to(x.device).long()
    bw = min(min_bw, (F + 1) // max(n, 1))
    slot = torch.arange(raw.shape[0], device=x.device)
    raw = torch.where(slot < n - 1, raw, torch.full_like(raw, F))
    interior = torch.sort(raw).values + torch.where(
        slot < n - 1, (slot + 1) * bw, torch.zeros_like(slot))
    interior = torch.clamp(interior, max=F)
    g_db = torch.as_tensor(g_db).to(x.device).float()
    if filter_type == "step":
        return _band_gain_filter(x, n, interior, 10.0 ** (g_db / 20.0),
                                 linear_db=False)
    return _band_gain_filter(x, n, interior, g_db, linear_db=True)


def _filt_aug_branch(gen, x, db_range, n_band, min_bw, filter_type):
    B, T, F = x.shape
    n_max = max(n_band[1] - 1, 2)                  # randint is [low, high)
    n = int(_randint(gen, n_band[0], n_band[1]))
    bw = min(min_bw, (F + 1) // max(n, 1))
    raw = _randint(gen, 0, max(F - n * bw + 1, 1), (n_max - 1,))
    cols = n_max if filter_type == "step" else n_max + 1
    g_db = _uniform(gen, (B, cols), *db_range)
    return filt_aug_apply(x, n, raw, g_db, min_bw, filter_type)


def filt_aug(gen: torch.Generator, x: torch.Tensor,
             db_range: Sequence[float] = (-6.0, 6.0),
             n_band: Sequence[int] = (3, 6), min_bw: int = 6,
             filter_type: Union[str, float] = "linear") -> torch.Tensor:
    """Updated (ICASSP 2022) FilterAugment (FilterAugment.py:142-192):
    n in [n_band[0], n_band[1]) bands at sorted integer boundaries with a
    minimum bandwidth, per-example per-band dB gains, filled stepwise or
    interpolated, applied as 10**(dB/20). A float ``filter_type`` is the
    reference's mixed mode: with that probability the step
    parameterisation (n_band [2, 5], min_bw 4), else linear ([3, 6], 6);
    only the chosen branch draws."""
    if isinstance(filter_type, str):
        return _filt_aug_branch(gen, x, tuple(db_range), tuple(n_band),
                                min_bw, filter_type)
    if float(_uniform(gen, ())) < filter_type:
        return _filt_aug_branch(gen, x, tuple(db_range), (2, 5), 4, "step")
    return _filt_aug_branch(gen, x, tuple(db_range), (3, 6), 6, "linear")


def filt_aug_prototype_apply(x: torch.Tensor, n: int, raw: torch.Tensor,
                             g_db: torch.Tensor) -> torch.Tensor:
    """The prototype FilterAugment on given draws: ``n`` bands, ``raw``
    ``[n_max - 1]`` boundary draws in [1, F - 1) (the first ``n - 1``
    real), step gains ``g_db`` ``[B, n_max]`` in dB."""
    F = x.shape[2]
    n = int(n)
    raw = torch.as_tensor(raw).to(x.device).long()
    slot = torch.arange(raw.shape[0], device=x.device)
    interior = torch.sort(torch.where(slot < n - 1, raw,
                                      torch.full_like(raw, F))).values
    interior = torch.clamp(interior, max=F)
    gains = 10.0 ** (torch.as_tensor(g_db).to(x.device).float() / 20.0)
    return _band_gain_filter(x, n, interior, gains, linear_db=False)


def filt_aug_prototype(gen: torch.Generator, x: torch.Tensor,
                       db_range: Sequence[float] = (-7.5, 6.0),
                       n_bands: Sequence[int] = (2, 5)) -> torch.Tensor:
    """Prototype (DCASE 2021) FilterAugment (FilterAugment.py:119-139):
    n in [n_bands[0], n_bands[1]) bands at sorted boundaries drawn from
    [1, F - 1), per-example per-band step gains 10**(U(db_range)/20).
    Duplicate boundaries give empty bands, the later band winning a
    shared boundary."""
    B, T, F = x.shape
    n_max = max(n_bands[1] - 1, 2)
    n = int(_randint(gen, n_bands[0], n_bands[1]))
    raw = _randint(gen, 1, max(F - 1, 2), (n_max - 1,))
    g_db = _uniform(gen, (B, n_max), *db_range)
    return filt_aug_prototype_apply(x, n, raw, g_db)


# ----------------------------------------------------------------------
# freq_mask, add_noise
# ----------------------------------------------------------------------
def freq_mask_apply(x: torch.Tensor, widths: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    """Zero the bins ``[starts_i, starts_i + widths_i)`` of example i."""
    f = torch.arange(x.shape[2], device=x.device)[None, :]
    widths = torch.as_tensor(widths, device=x.device)[:, None]
    starts = torch.as_tensor(starts, device=x.device)[:, None]
    mask = (f >= starts) & (f < starts + widths)
    return torch.where(mask[:, None, :], torch.zeros_like(x), x)


def freq_mask(gen: torch.Generator, x: torch.Tensor,
              mask_ratio: int = 16) -> torch.Tensor:
    """Zero one frequency band PER EXAMPLE: width_i in [1, F/ratio) (1
    when F/ratio <= 1), start_i in [0, F - width_i)
    (FilterAugment.py:195-209)."""
    B, T, F = x.shape
    max_mask = int(F / mask_ratio)
    if max_mask <= 1:
        widths = torch.ones(B, dtype=torch.int64, device=gen.device)
    else:
        widths = _randint(gen, 1, max_mask, (B,))
    # start_i uniform over [0, max(F - width_i, 1)): one uniform per row
    span = torch.clamp(F - widths, min=1)
    starts = torch.floor(_uniform(gen, (B,)) * span).long()
    return freq_mask_apply(x, widths, torch.minimum(starts, span - 1))


def add_noise_apply(x: torch.Tensor, snr, noise: torch.Tensor,
                    dims: Tuple[int, int] = (1, 2)) -> torch.Tensor:
    """``x + noise * unbiased-std(x, dims) / 10**(snr/20)``."""
    snr = torch.as_tensor(snr, dtype=x.dtype, device=x.device)
    sigma = torch.std(x, dim=dims, keepdim=True, correction=1) \
        / 10.0 ** (snr / 20.0)
    return x + noise.to(x.device, x.dtype) * sigma


def add_noise(gen: torch.Generator, x: torch.Tensor,
              snrs: Union[Sequence[float], float] = (15.0, 30.0),
              dims: Tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Additive white noise at a per-example feature-domain SNR:
    snr_i = (snrs[0] - snrs[1]) U[0, 1) + snrs[1], noise std =
    unbiased-std(x, dims) / 10**(snr/20) (FilterAugment.py:212-224)."""
    if isinstance(snrs, (list, tuple)):
        u = _uniform(gen, (x.shape[0],) + (1,) * (x.dim() - 1))
        snr = (snrs[0] - snrs[1]) * u + snrs[1]
    else:
        snr = snrs
    noise = torch.randn(x.shape, generator=gen, device=gen.device)
    return add_noise_apply(x, snr, noise, dims)


def feature_transformation(gen: torch.Generator, x: torch.Tensor,
                           n_transform: int, choice: Sequence[bool],
                           filtaug_choice: str = "updated",
                           filter_db_range: Sequence[float] = (-6.0, 6.0),
                           filter_bands: Sequence[int] = (3, 6),
                           filter_minimum_bandwidth: int = 6,
                           filter_type: Union[str, float] = "linear",
                           freq_mask_ratio: int = 16,
                           noise_snrs: Sequence[float] = (15.0, 30.0)):
    """The reference's dispatcher (FilterAugment.py:83-116): the
    (filt_aug?, freq_mask?, add_noise?) ``choice`` pipeline applied
    ``n_transform`` times with fresh draws (2: two augmented views; 1:
    one view twice; else the input twice)."""
    def one():
        y = x
        if choice[0]:
            if filtaug_choice == "prototype":
                y = filt_aug_prototype(gen, y, db_range=filter_db_range,
                                       n_bands=filter_bands)
            else:
                y = filt_aug(gen, y, db_range=filter_db_range,
                             n_band=filter_bands,
                             min_bw=filter_minimum_bandwidth,
                             filter_type=filter_type)
        if choice[1]:
            y = freq_mask(gen, y, mask_ratio=freq_mask_ratio)
        if choice[2]:
            y = add_noise(gen, y, snrs=noise_snrs)
        return y

    if n_transform == 2:
        return [one(), one()]
    if n_transform == 1:
        y = one()
        return [y, y]
    return [x, x]
