"""Heads that sum a classification margin head and the angular
prototypical head (port of ``losses/combined.py``).

Each takes ``x [B, 2, D]`` (nPerSpeaker exactly 2) and ``label [B]``.
The sub-heads keep the flax names: ``Softmax_0/Dense_0``,
``AmSoftmax_0/W``, ``AAmSoftmax_0/weight``, ``AngularProto_0/{w,b}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from speakerverification_tpu_torch.losses.margin import (
    AAmSoftmax,
    AmSoftmax,
    Softmax,
)
from speakerverification_tpu_torch.losses.proto import (
    AngularProto,
    check_grouped,
)
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["SoftmaxAngularProto", "AmSoftmaxProto", "AAmSoftmaxProto",
           "AAmSoftmaxAP"]


@LOSSES.register("SoftmaxAngularProto")
class SoftmaxAngularProto(nn.Module):
    """Softmax + AngularProto; prec1 of the softmax head."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 init_w: float = 10.0, init_b: float = -5.0):
        super().__init__()
        self.Softmax_0 = Softmax(nOut, nClasses)
        self.AngularProto_0 = AngularProto(init_w, init_b)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        check_grouped(x, "SoftmaxAngularProto", exactly=2)
        loss_s, prec1 = self.Softmax_0(x, label)
        loss_p, _ = self.AngularProto_0(x)
        return loss_s + loss_p, prec1


@LOSSES.register("AmSoftmaxProto")
class AmSoftmaxProto(nn.Module):
    """AM-softmax + AngularProto; prec1 of the AM-softmax head."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.1, scale: float = 30.0,
                 init_w: float = 10.0, init_b: float = -5.0):
        super().__init__()
        self.AmSoftmax_0 = AmSoftmax(nOut, nClasses, margin, scale)
        self.AngularProto_0 = AngularProto(init_w, init_b)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        check_grouped(x, "AmSoftmaxProto", exactly=2)
        loss_m, prec1 = self.AmSoftmax_0(x, label)
        loss_p, _ = self.AngularProto_0(x)
        return loss_m + loss_p, prec1


@LOSSES.register("AAmSoftmaxProto")
class AAmSoftmaxProto(nn.Module):
    """AAM-softmax + AngularProto; prec1 of the AAM-softmax head."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.2, scale: float = 30.0,
                 easy_margin: bool = False, init_w: float = 10.0,
                 init_b: float = -5.0):
        super().__init__()
        self.AAmSoftmax_0 = AAmSoftmax(nOut, nClasses, margin, scale,
                                       easy_margin)
        self.AngularProto_0 = AngularProto(init_w, init_b)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        check_grouped(x, "AAmSoftmaxProto", exactly=2)
        loss_m, prec1 = self.AAmSoftmax_0(x, label)
        loss_p, _ = self.AngularProto_0(x)
        return loss_m + loss_p, prec1


@LOSSES.register("AAmSoftmaxAP")
class AAmSoftmaxAP(nn.Module):
    """(AAM-softmax + AngularProto + Softmax) / 3; prec1 of the softmax
    head."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.2, scale: float = 30.0,
                 easy_margin: bool = False, init_w: float = 10.0,
                 init_b: float = -5.0):
        super().__init__()
        self.AAmSoftmax_0 = AAmSoftmax(nOut, nClasses, margin, scale,
                                       easy_margin)
        self.AngularProto_0 = AngularProto(init_w, init_b)
        self.Softmax_0 = Softmax(nOut, nClasses)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        check_grouped(x, "AAmSoftmaxAP", exactly=2)
        loss_aam, _ = self.AAmSoftmax_0(x, label)
        loss_ap, _ = self.AngularProto_0(x)
        loss_s, prec1 = self.Softmax_0(x, label)
        return (loss_aam + loss_ap + loss_s) / 3.0, prec1
