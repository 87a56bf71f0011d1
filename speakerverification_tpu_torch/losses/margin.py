"""Classification-margin heads (port of ``losses/margin.py``): Softmax,
AM-softmax (CosFace) and AAM-softmax (ArcFace).

Each head is called as ``head(x, label) -> (loss, prec1)`` with ``x``
``[B, nPerSpeaker, D]`` or ``[B, D]``; ``prec1`` is top-1 accuracy in
percent. The parameters keep the flax names and layouts: Softmax's
``Dense_0`` (a Linear), AmSoftmax's ``W [nOut, nClasses]``, AAmSoftmax's
``weight [nClasses, nOut]``.
"""

from __future__ import annotations

import math

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
from speakerverification_tpu_torch.models.layers import promoted
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["Softmax", "AmSoftmax", "AAmSoftmax"]


@LOSSES.register("Softmax")
class Softmax(nn.Module):
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994):
        super().__init__()
        self.Dense_0 = nn.Linear(nOut, nClasses)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        logits = promoted(self.Dense_0, x)
        return cross_entropy(logits, label), top1_percent(logits, label)


@LOSSES.register("AmSoftmax")
class AmSoftmax(nn.Module):
    """CosFace: ``s * (cosθ - m)`` at the target class."""
    test_normalize = True
    # initialized by weights.init_weights_ as flax's xavier_normal
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
        return cross_entropy(logits, label), top1_percent(logits, label)


@LOSSES.register("AAmSoftmax")
class AAmSoftmax(nn.Module):
    """ArcFace: ``s * cos(θ + m)`` at the target class, kept monotonic in
    θ (``cosine - mm`` past ``th``) unless ``easy_margin``."""
    test_normalize = True
    xavier_normal_params = ("weight",)

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.2, scale: float = 30.0,
                 easy_margin: bool = False):
        super().__init__()
        self.nClasses, self.margin, self.scale = nClasses, margin, scale
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.empty(nClasses, nOut))
        nn.init.xavier_normal_(self.weight)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        cosine = promoted_matmul(l2_normalize(x, -1),
                                 l2_normalize(self.weight, -1).T)
        cos_m, sin_m = math.cos(self.margin), math.sin(self.margin)
        th = math.cos(math.pi - self.margin)
        mm = math.sin(math.pi - self.margin) * self.margin
        sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
        phi = cosine * cos_m - sine * sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine - th > 0, phi, cosine - mm)
        one_hot = F.one_hot(label.long(), self.nClasses).to(cosine.dtype)
        logits = self.scale * (one_hot * phi + (1.0 - one_hot) * cosine)
        return cross_entropy(logits, label), top1_percent(logits, label)
