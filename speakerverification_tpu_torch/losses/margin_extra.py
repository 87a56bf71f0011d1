"""ARmSoftmax (port of ``losses/margin_extra.py``): AM-softmax logits,
then each row's logits below its own target logit are set to zero
before the cross-entropy (the "relative" margin)."""

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

__all__ = ["ARmSoftmax"]


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
