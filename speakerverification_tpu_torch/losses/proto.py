"""Metric-learning heads (port of ``losses/proto.py``): angular
prototypical, prototypical and the GE2E family.

Each takes grouped embeddings ``x [B, nPerSpeaker, D]`` (at least two
per speaker; the label is not used) and returns ``(loss, prec1)``.
``AngularProto``'s logits scale ``w`` is clamped at 1e-6 before use,
as the JAX module clamps it (the reference computes the clamp and
discards it). ``w`` and ``b`` are 0-d parameters named as flax's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.losses.common import (
    cross_entropy,
    l2_normalize,
    top1_percent,
)
from speakerverification_tpu_torch.models.layers import at_least_fp32
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["AngularProto", "Prototypical", "GE2ELoss", "GE2ELossV2",
           "GE2ELossFusion", "check_grouped"]


def check_grouped(x: torch.Tensor, head: str, exactly: int = 0) -> None:
    """Refuse embeddings that are not ``[B, nPerSpeaker, D]`` with at
    least two per speaker (``exactly`` of them, where given)."""
    n = x.shape[1] if x.dim() == 3 else 0
    if n < 2 or (exactly and n != exactly):
        want = f"exactly {exactly}" if exactly else "at least 2"
        raise ValueError(f"{head} takes embeddings [B, nPerSpeaker, D] with "
                         f"{want} per speaker (dataloader_options."
                         f"nPerSpeaker), got shape {tuple(x.shape)}")


def _anchor_positive(x: torch.Tensor):
    """Utterance 0 of each speaker and the mean of the others (reduced in
    fp32 at least, as ``jnp.mean``)."""
    anchor = at_least_fp32(x[:, 1:, :]).mean(dim=1).to(x.dtype)
    return anchor, x[:, 0, :]


def _scalar_params(init_w: float, init_b: float):
    return (nn.Parameter(torch.tensor(float(init_w))),
            nn.Parameter(torch.tensor(float(init_b))))


@LOSSES.register("AngularProto")
class AngularProto(nn.Module):
    """Cross-entropy over ``w · cos(positive_i, anchor_j) + b``: each
    speaker's positive against every speaker's anchor."""
    test_normalize = True

    def __init__(self, init_w: float = 10.0, init_b: float = -5.0):
        super().__init__()
        self.w, self.b = _scalar_params(init_w, init_b)

    def forward(self, x: torch.Tensor, label=None):
        check_grouped(x, "AngularProto")
        anchor, positive = _anchor_positive(x)
        cos = l2_normalize(positive) @ l2_normalize(anchor).T
        logits = cos * torch.clamp(self.w, min=1e-6) + self.b
        labels = torch.arange(x.shape[0], device=x.device)
        return cross_entropy(logits, labels), top1_percent(logits, labels)


@LOSSES.register("Prototypical")
class Prototypical(nn.Module):
    """Cross-entropy over ``-||positive_i - anchor_j||²``."""
    test_normalize = False

    def forward(self, x: torch.Tensor, label=None):
        check_grouped(x, "Prototypical")
        anchor, positive = _anchor_positive(x)
        d2 = (torch.sum(positive ** 2, -1)[:, None]
              + torch.sum(anchor ** 2, -1)[None, :]
              - 2.0 * positive @ anchor.T)
        logits = -torch.clamp(d2, min=0.0)
        labels = torch.arange(x.shape[0], device=x.device)
        return cross_entropy(logits, labels), top1_percent(logits, labels)


def _ge2e(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          loss_method: str, eps: float, clamp_cos: bool):
    """GE2E over ``x [N, M, D]``: each utterance's cosine to every
    speaker's centroid, its own speaker's centroid leaving it out;
    ``softmax`` or ``contrast`` loss, summed. ``clamp_cos`` clamps the
    cosines at 1e-6 (GE2ELossV2)."""
    N, M, _ = x.shape
    centroids = at_least_fp32(x).mean(dim=1).to(x.dtype)             # [N, D]
    loo = (x.sum(dim=1, keepdim=True) - x) / (M - 1)                # [N, M, D]
    xn, cn, ln = (l2_normalize(v, eps=eps) for v in (x, centroids, loo))
    cos = torch.einsum("jid,kd->jik", xn, cn)                       # [N, M, N]
    own = torch.einsum("jid,jid->ji", xn, ln)                       # [N, M]
    eye = torch.eye(N, dtype=torch.bool, device=x.device)[:, None, :]
    cos = torch.where(eye, own[:, :, None], cos)
    if clamp_cos:
        cos = torch.clamp(cos, min=1e-6)
    sim = cos * torch.clamp(w, min=1e-6) + b
    spk = torch.arange(N, device=x.device)
    if loss_method == "softmax":
        loss = -torch.sum(F.log_softmax(sim, dim=2)[spk, :, spk])
    elif loss_method == "contrast":
        sig = torch.sigmoid(sim)
        own_sig = sig[spk, :, spk]
        masked = torch.where(eye, torch.full_like(sig, float("-inf")), sig)
        loss = torch.sum(1.0 - own_sig + masked.max(dim=2).values)
    else:
        raise ValueError(f"unknown loss_method {loss_method!r}")
    labels = torch.repeat_interleave(spk, M)
    return loss, top1_percent(sim.reshape(N * M, N), labels)


@LOSSES.register("GE2ELoss")
class GE2ELoss(nn.Module):
    """GE2E, ``loss_method`` ``softmax`` or ``contrast`` (norms clamped
    at 1e-6, the reference's cosine eps)."""
    test_normalize = True

    def __init__(self, init_w: float = 10.0, init_b: float = -5.0,
                 loss_method: str = "softmax"):
        super().__init__()
        if loss_method not in ("softmax", "contrast"):
            raise ValueError(f"unknown loss_method {loss_method!r}")
        self.loss_method = loss_method
        self.w, self.b = _scalar_params(init_w, init_b)

    def forward(self, x: torch.Tensor, label=None):
        check_grouped(x, "GE2ELoss")
        return _ge2e(x, self.w, self.b, self.loss_method, 1e-6, False)


@LOSSES.register("GE2ELossV2")
class GE2ELossV2(GE2ELoss):
    """GE2E with the cosines clamped at 1e-6 (norms clamped at 1e-12)."""

    def forward(self, x: torch.Tensor, label=None):
        check_grouped(x, "GE2ELossV2")
        return _ge2e(x, self.w, self.b, self.loss_method, 1e-12, True)


@LOSSES.register("GE2ELoss_fusion")
class GE2ELossFusion(nn.Module):
    """The softmax and the contrast GE2ELossV2 summed, each with its own
    ``w`` and ``b``; prec1 of the softmax one."""
    test_normalize = True

    def __init__(self, init_w: float = 10.0, init_b: float = -5.0):
        super().__init__()
        self.GE2ELossV2_0 = GE2ELossV2(init_w, init_b, "softmax")
        self.GE2ELossV2_1 = GE2ELossV2(init_w, init_b, "contrast")

    def forward(self, x: torch.Tensor, label=None):
        loss_s, prec1 = self.GE2ELossV2_0(x, label)
        loss_c, _ = self.GE2ELossV2_1(x, label)
        return loss_s + loss_c, prec1
