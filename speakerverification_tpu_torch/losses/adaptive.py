"""The hierarchical adaptive softmax heads (port of ``losses/adaptive.py``):
``adasoftmax_v1`` and ``adasoftmax_v2``.

A head over the ``cutoff[0]`` first classes plus one slot per tail
cluster, and per-cluster tails behind a rank-reduced projection. The
loss is the negative log-probability of the target under the composed
distribution (head log-prob of the cluster's slot plus the tail's
log-prob within the cluster), computed over all classes. The layers keep
the flax names: ``head``, ``tail{i}_proj`` and ``tail{i}_out`` (Linears;
the weight bridge transposes their Dense kernels).

* ``v1``: tail ``i`` projects to ``nOut // reduce_factor**i`` (the
  first tail is not reduced) and its output layer has a bias;
* ``v2``: tail ``i`` projects to ``nOut // reduce_factor**(i + 1)`` and
  neither tail layer has a bias.

``variant`` (a config key, as in JAX) overrides the registered name's.

The default ``cutoff`` is ``(max(nClasses // 4, 1), nClasses)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.losses.common import (
    flatten_grouped,
    top1_percent,
)
from speakerverification_tpu_torch.models.layers import promoted
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["AdaptiveSoftmaxLoss", "AdaptiveSoftmaxLossV1"]


def _default_cutoff(n_classes: int) -> tuple:
    return (max(n_classes // 4, 1), n_classes)


@LOSSES.register("adasoftmax_v2")
class AdaptiveSoftmaxLoss(nn.Module):
    test_normalize = True
    default_variant = "v2"

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 cutoff: Sequence[int] = (), reduce_factor: int = 4,
                 variant: str | None = None):
        super().__init__()
        self.variant = variant or self.default_variant
        cutoff = tuple(int(c) for c in cutoff) or _default_cutoff(nClasses)
        if cutoff[-1] != nClasses:
            raise ValueError(f"last cutoff {cutoff[-1]} must equal "
                             f"nClasses {nClasses}")
        self.cutoff = cutoff
        n_tails = len(cutoff) - 1
        self.head = nn.Linear(nOut, cutoff[0] + n_tails)
        for i in range(n_tails):
            if self.variant == "v1":
                proj = max(nOut // (reduce_factor ** i), 1)
            else:
                proj = max(nOut // (reduce_factor ** (i + 1)), 1)
            setattr(self, f"tail{i}_proj", nn.Linear(nOut, proj, bias=False))
            setattr(self, f"tail{i}_out",
                    nn.Linear(proj, cutoff[i + 1] - cutoff[i],
                              bias=self.variant == "v1"))

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        c0 = self.cutoff[0]
        head_logp = F.log_softmax(promoted(self.head, x), dim=-1)
        parts = [head_logp[:, :c0]]
        for i in range(len(self.cutoff) - 1):
            h = promoted(getattr(self, f"tail{i}_proj"), x)
            tail_logp = F.log_softmax(
                promoted(getattr(self, f"tail{i}_out"), h), dim=-1)
            parts.append(head_logp[:, c0 + i:c0 + i + 1] + tail_logp)
        logp = torch.cat(parts, dim=-1)
        loss = -torch.mean(logp.gather(1, label[:, None].long()))
        return loss, top1_percent(logp, label)


@LOSSES.register("adasoftmax_v1")
class AdaptiveSoftmaxLossV1(AdaptiveSoftmaxLoss):
    default_variant = "v1"
