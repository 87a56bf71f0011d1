"""SpecAugment on ``[B, T, F]`` features (port of ``ops/specaugment.py``):
time warp, then masks along time, then masks along frequency.

* Time warp: one pivot ``c`` ∈ [window, T−window) per batch moves to
  ``w`` ∈ [c−window+1, c+window]; [0, c) is resampled to w frames and
  [c, T) to T−w with torch's bicubic ``align_corners=True`` (Keys cubic,
  a = −0.75, indices clamped per segment), computed as a 4-tap gather in
  float32, floor and clip in the JAX package's order.
* Masks: ``n`` intervals per row, lengths in [w0, w1), positions in
  [0, D − max_len) with ``max_len`` the longest length in the batch;
  filled with zero, or with the mean of the tensor as it stands before
  each stage when ``replace_with_zero`` is off.

The random part is split from the arithmetic: :func:`draw_spec_augment`
draws every random number from a ``torch.Generator`` (on the features'
device) into a :class:`SpecAugmentDraw`, and :func:`apply_spec_augment`
is a deterministic function of the features and the draw, so a test
can feed it the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["SpecAugmentConfig", "SpecAugmentDraw", "MaskDraw",
           "draw_spec_augment", "apply_spec_augment", "spec_augment"]


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    time_warp: bool = True
    time_warp_window: int = 5
    freq_mask: bool = True
    freq_mask_width: Tuple[int, int] = (0, 20)
    n_freq_mask: int = 2
    time_mask: bool = True
    time_mask_width: Tuple[int, int] = (0, 20)
    n_time_mask: int = 2
    replace_with_zero: bool = True


class MaskDraw(NamedTuple):
    length: torch.Tensor     # [B, n_mask, 1] int64
    pos: torch.Tensor        # [B, n_mask, 1] int64


class SpecAugmentDraw(NamedTuple):
    warp: Optional[Tuple[torch.Tensor, torch.Tensor]]   # (c, w) scalars
    time: Optional[MaskDraw]
    freq: Optional[MaskDraw]


def _uniform_int(gen: torch.Generator, shape, lo, hi) -> torch.Tensor:
    """Integers uniform in [lo, hi) where the bounds may be tensors (no
    device sync)."""
    device = gen.device
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return (torch.as_tensor(lo, device=device)
            + torch.floor(u * (torch.as_tensor(hi, device=device)
                               - torch.as_tensor(lo, device=device)))
            ).to(torch.int64)


def _draw_mask(gen: torch.Generator, B: int, axis_len: int, n_mask: int,
               width: Tuple[int, int]) -> MaskDraw:
    w0, w1 = width
    w1 = max(w1, w0 + 1)
    length = torch.randint(w0, w1, (B, n_mask, 1), generator=gen,
                           device=gen.device)
    hi = torch.clamp(axis_len - length.max(), min=1)
    return MaskDraw(length, _uniform_int(gen, (B, n_mask, 1), 0, hi))


def draw_spec_augment(gen: torch.Generator, shape,
                      cfg: SpecAugmentConfig) -> SpecAugmentDraw:
    """Every random number of one SpecAugment call on features of
    ``shape [B, T, F]``, drawn on ``gen``'s device."""
    B, T, F = shape
    warp = time = freq = None
    window = cfg.time_warp_window
    if cfg.time_warp and T - window > window:
        c = _uniform_int(gen, (), window, T - window)
        w = _uniform_int(gen, (), c - window, c + window) + 1
        warp = (c, w)
    if cfg.time_mask:
        time = _draw_mask(gen, B, T, cfg.n_time_mask, cfg.time_mask_width)
    if cfg.freq_mask:
        freq = _draw_mask(gen, B, F, cfg.n_freq_mask, cfg.freq_mask_width)
    return SpecAugmentDraw(warp, time, freq)


def _cubic_coeffs(t: torch.Tensor):
    """torch's bicubic tap weights (A = −0.75) for the samples at
    floor−1 … floor+2 of a fractional offset ``t`` ∈ [0, 1)."""
    a = -0.75

    def c1(x):                                   # |x| ≤ 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def c2(x):                                   # 1 < |x| ≤ 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return c2(t + 1.0), c1(t), c1(1.0 - t), c2(2.0 - t)


def _time_warp(x: torch.Tensor, c: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    B, T, F = x.shape
    xf = x.float()
    cf, wf = c.float(), w.float()
    Tf = torch.tensor(float(T), device=x.device)
    t_out = torch.arange(T, device=x.device, dtype=torch.float32)
    left = t_out < wf
    loc_out = torch.where(left, t_out, t_out - wf)   # segment-local index
    out_len = torch.where(left, wf, Tf - wf)
    in_len = torch.where(left, cf, Tf - cf)
    seg0 = torch.where(left, torch.zeros_like(cf), cf)
    scale = torch.where(out_len > 1.0,
                        (in_len - 1.0) / torch.clamp(out_len - 1.0, min=1.0),
                        torch.zeros_like(out_len))
    src = loc_out * scale
    i0 = torch.floor(src)
    out = torch.zeros_like(xf)
    for k, wt in zip((-1.0, 0.0, 1.0, 2.0), _cubic_coeffs(src - i0)):
        idx = (torch.minimum(torch.clamp(i0 + k, min=0.0), in_len - 1.0)
               + seg0).to(torch.int32).long()
        out = out + wt[None, :, None] * xf[:, idx, :]
    return out.to(x.dtype)


def _mask(x: torch.Tensor, draw: MaskDraw, axis: int,
          fill: Optional[torch.Tensor]) -> torch.Tensor:
    if fill is None:
        fill = x.mean()
    axis_len = x.shape[axis]
    ar = torch.arange(axis_len, device=x.device)[None, None, :]
    mask = ((draw.pos <= ar) & (ar < draw.pos + draw.length)).any(dim=1)
    shape = [x.shape[0], 1, 1]
    shape[axis] = axis_len
    return torch.where(mask.reshape(shape), fill.to(x.dtype), x)


def apply_spec_augment(x: torch.Tensor, draw: SpecAugmentDraw,
                       cfg: SpecAugmentConfig) -> torch.Tensor:
    """SpecAugment of ``x [B, T, F]`` with the random numbers of ``draw``."""
    fill = None if not cfg.replace_with_zero else torch.zeros(
        (), dtype=x.dtype, device=x.device)
    if draw.warp is not None:
        x = _time_warp(x, *draw.warp)
    if draw.time is not None:
        x = _mask(x, draw.time, 1, fill)
    if draw.freq is not None:
        x = _mask(x, draw.freq, 2, fill)
    return x


def spec_augment(x: torch.Tensor, cfg: SpecAugmentConfig,
                 rng: Union[torch.Generator, SpecAugmentDraw, None]
                 ) -> torch.Tensor:
    """SpecAugment of ``x [B, T, F]``: its numbers drawn from the
    generator ``rng``, or taken from ``rng`` when it is a draw."""
    if rng is None:
        raise ValueError("SpecAugment in training needs a generator: pass "
                         "rng to the model's forward")
    draw = rng if isinstance(rng, SpecAugmentDraw) else draw_spec_augment(
        rng, x.shape, cfg)
    return apply_spec_augment(x, draw, cfg)
