"""The extra margin heads (port of ``losses/margin_extra.py``).

* ``ARmSoftmax``: AM-softmax logits, then each row's logits below its
  own target logit are set to zero before the cross-entropy (the
  "relative" margin).
* ``AngularPenaltySMLoss``: the arcface, sphereface or cosface numerator
  at the target cosine (clipped ``eps`` inside ±1) against the scaled
  cosines of the other classes, over ``W [nOut, nClasses]``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.losses.common import (
    cross_entropy,
    flatten_grouped,
    l2_normalize,
    promoted_matmul,
    top1_percent,
)
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["ARmSoftmax", "AngularPenaltySMLoss"]


@LOSSES.register("ARmSoftmax")
class ARmSoftmax(nn.Module):
    """``W [nOut, nClasses]``, normalized per class column."""
    test_normalize = True
    xavier_normal_params = ("W",)

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.1, scale: float = 30.0):
        super().__init__()
        self.nClasses, self.margin, self.scale = nClasses, margin, scale
        self.W = nn.Parameter(torch.empty(nOut, nClasses))
        nn.init.xavier_normal_(self.W)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        costh = promoted_matmul(l2_normalize(x, -1),
                                l2_normalize(self.W, 0))
        one_hot = F.one_hot(label.long(), self.nClasses).to(costh.dtype)
        logits = self.scale * (costh - self.margin * one_hot)
        own = logits.gather(1, label[:, None].long())
        relu_logits = torch.where(logits - own < 0.0,
                                  torch.zeros_like(logits), logits)
        return (cross_entropy(relu_logits, label),
                top1_percent(relu_logits, label))


# (scale, margin) of each loss type where the config gives none
_ANGULAR_DEFAULTS = {"arcface": (64.0, 0.5), "sphereface": (64.0, 1.35),
                     "cosface": (30.0, 0.4)}


@LOSSES.register("AngularPenaltySMLoss")
class AngularPenaltySMLoss(nn.Module):
    """``W [nOut, nClasses]`` (flax's ``lecun_normal``); prec1 over the
    unscaled cosines."""
    test_normalize = True
    lecun_normal_params = ("W",)

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 loss_type: str = "arcface", margin: float | None = None,
                 scale: float | None = None, eps: float = 1e-7):
        super().__init__()
        if loss_type not in _ANGULAR_DEFAULTS:
            raise KeyError(f"unknown loss_type {loss_type!r}; known: "
                           f"{sorted(_ANGULAR_DEFAULTS)}")
        s0, m0 = _ANGULAR_DEFAULTS[loss_type]
        self.loss_type, self.nClasses, self.eps = loss_type, nClasses, eps
        self.s = s0 if scale is None else scale
        self.m = m0 if margin is None else margin
        self.W = nn.Parameter(torch.empty(nOut, nClasses))
        nn.init.xavier_normal_(self.W)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        s, m = self.s, self.m
        wf = promoted_matmul(l2_normalize(x, -1), l2_normalize(self.W, 0))
        own = wf.gather(1, label[:, None].long())[:, 0]
        own = torch.clamp(own, -1.0 + self.eps, 1.0 - self.eps)
        if self.loss_type == "cosface":
            numerator = s * (own - m)
        elif self.loss_type == "arcface":
            numerator = s * torch.cos(torch.arccos(own) + m)
        else:                                              # sphereface
            numerator = s * torch.cos(m * torch.arccos(own))
        one_hot = F.one_hot(label.long(), self.nClasses) > 0
        excl = torch.where(one_hot, torch.full_like(wf, float("-inf")),
                           s * wf)
        e = torch.exp(excl)
        denom = torch.exp(numerator) + torch.sum(
            torch.where(torch.isfinite(excl), e, torch.zeros_like(e)), dim=1)
        loss = -torch.mean(numerator - torch.log(denom))
        return loss, top1_percent(wf, label)
