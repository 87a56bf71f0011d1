"""Pair-similarity heads (port of ``losses/similarity.py``):
``MultiSimilarity``, ``MultiSimilarity_v2``, ``MSSoftmax``,
``MSAmSoftmax``, ``CircleLoss`` and ``CircleLossV2``.

Each flattens ``x [B, nPerSpeaker, D]`` to ``[B·nPerSpeaker, D]`` with
repeated labels. prec1 is the share of items whose nearest other item
(by raw or cosine similarity, as the head computes it) has the same
label. ``CircleLoss`` works on the raw embeddings, as the JAX head does
(the reference's forward never normalizes); ``CircleLossV2``
normalizes them with ``similarity: cos``. The summed heads keep flax's
auto-names: ``MSSoftmax`` holds ``Softmax_0``, ``MSAmSoftmax``
``ARmSoftmax_0``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from speakerverification_tpu_torch.losses.common import (
    flatten_grouped,
    l2_normalize,
)
from speakerverification_tpu_torch.losses.margin import Softmax
from speakerverification_tpu_torch.losses.margin_extra import ARmSoftmax
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["MultiSimilarity", "MultiSimilarityV2", "MSSoftmax",
           "MSAmSoftmax", "CircleLoss", "CircleLossV2"]


def _masked_sum_exp(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``sum(exp(values) · mask)`` over the last axis."""
    e = torch.exp(values)
    return torch.sum(torch.where(mask, e, torch.zeros_like(e)), dim=-1)


def _fill(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(x, value)


def _nearest_same_label(sim: torch.Tensor, labels: torch.Tensor):
    """100 × the share of rows whose most similar other column has the
    row's label."""
    eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    nn_idx = torch.argmax(torch.where(eye, _fill(sim, float("-inf")), sim),
                          dim=1)
    return 100.0 * (labels[nn_idx] == labels).float().mean()


def _ms_terms(sim, sel_pos, sel_neg, scale_pos, scale_neg, thresh):
    pos = (1.0 / scale_pos) * torch.log1p(_masked_sum_exp(
        -scale_pos * (sim - thresh), sel_pos))
    neg = (1.0 / scale_neg) * torch.log1p(_masked_sum_exp(
        scale_neg * (sim - thresh), sel_neg))
    return pos + neg


@LOSSES.register("MultiSimilarity")
class MultiSimilarity(nn.Module):
    """Hard-pair mining and log-sum-exp weighting over the row-normalized
    similarity matrix; rows without a mined positive and negative do not
    count."""
    test_normalize = True

    def __init__(self, margin: float = 0.1, scale_pos: float = 2.0,
                 scale_neg: float = 50.0, thresh: float = 0.5):
        super().__init__()
        self.margin, self.thresh = margin, thresh
        self.scale_pos, self.scale_neg = scale_pos, scale_neg

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feats, labels = flatten_grouped(x, label)
        B = feats.shape[0]
        sim = feats @ feats.T
        simn = sim / torch.clamp(torch.linalg.vector_norm(
            sim, dim=1, keepdim=True), min=1e-12)
        eps = 1e-5
        same = labels[:, None] == labels[None, :]
        pos_mask = same & (simn < 1 - eps)
        neg_mask = ~same
        min_pos = torch.where(pos_mask, simn, _fill(simn, float("inf"))
                              ).min(dim=1).values
        max_neg = torch.where(neg_mask, simn, _fill(simn, float("-inf"))
                              ).max(dim=1).values
        sel_neg = neg_mask & (simn > (min_pos - self.margin)[:, None])
        sel_pos = pos_mask & (simn < (max_neg + self.margin)[:, None])
        valid = sel_neg.any(dim=1) & sel_pos.any(dim=1)
        terms = _ms_terms(simn, sel_pos, sel_neg, self.scale_pos,
                          self.scale_neg, self.thresh)
        loss = torch.sum(torch.where(valid, terms, _fill(terms, 0.0))) / B
        return loss, _nearest_same_label(sim, labels)


@LOSSES.register("MultiSimilarity_v2")
class MultiSimilarityV2(nn.Module):
    """The MS miner (``epsilon``) and MS loss on cosine similarities,
    averaged over the rows with a mined pair."""
    test_normalize = True

    def __init__(self, epsilon: float = 0.1, scale_pos: float = 2.0,
                 scale_neg: float = 50.0, thresh: float = 0.5):
        super().__init__()
        self.epsilon, self.thresh = epsilon, thresh
        self.scale_pos, self.scale_neg = scale_pos, scale_neg

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feats, labels = flatten_grouped(x, label)
        fn = l2_normalize(feats, -1)
        sim = fn @ fn.T
        eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
        equal = labels[:, None] == labels[None, :]
        same = equal & ~eye
        diff = ~equal
        min_pos = torch.where(same, sim, _fill(sim, float("inf"))
                              ).min(dim=1).values
        max_neg = torch.where(diff, sim, _fill(sim, float("-inf"))
                              ).max(dim=1).values
        sel_neg = diff & (sim + self.epsilon > min_pos[:, None])
        sel_pos = same & (sim - self.epsilon < max_neg[:, None])
        terms = _ms_terms(sim, sel_pos, sel_neg, self.scale_pos,
                          self.scale_neg, self.thresh)
        valid = sel_pos.any(dim=1) | sel_neg.any(dim=1)
        denom = torch.clamp(valid.sum(), min=1)
        loss = torch.sum(torch.where(valid, terms, _fill(terms, 0.0))) / denom
        return loss, _nearest_same_label(sim, labels)


@LOSSES.register("MSSoftmax")
class MSSoftmax(nn.Module):
    """Softmax + MultiSimilarity; prec1 of the softmax head."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.1, scale_pos: float = 2.0,
                 scale_neg: float = 50.0):
        super().__init__()
        self.Softmax_0 = Softmax(nOut, nClasses)
        self.MultiSimilarity_0 = MultiSimilarity(margin, scale_pos,
                                                 scale_neg)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        if x.dim() != 3:
            raise ValueError("MSSoftmax takes embeddings [B, nPerSpeaker, "
                             f"D], got shape {tuple(x.shape)}")
        loss_s, prec1 = self.Softmax_0(x, label)
        loss_ms, _ = self.MultiSimilarity_0(x, label)
        return loss_s + loss_ms, prec1


@LOSSES.register("MSAmSoftmax")
class MSAmSoftmax(nn.Module):
    """``(1 - weight)·ARmSoftmax + weight·MultiSimilarity_v2``; prec1 of
    the ARmSoftmax head."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.1, scale: float = 30.0,
                 weight: float = 0.6):
        super().__init__()
        self.weight = weight
        self.ARmSoftmax_0 = ARmSoftmax(nOut, nClasses, margin, scale)
        self.MultiSimilarityV2_0 = MultiSimilarityV2()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        loss_ce, prec1 = self.ARmSoftmax_0(x, label)
        loss_ms, _ = self.MultiSimilarityV2_0(x, label)
        return (1 - self.weight) * loss_ce + self.weight * loss_ms, prec1


def _upper_pair_masks(labels: torch.Tensor):
    B = labels.shape[0]
    same = labels[:, None] == labels[None, :]
    triu = torch.triu(torch.ones(B, B, dtype=torch.bool,
                                 device=labels.device), diagonal=1)
    return same & triu, ~same & triu


@LOSSES.register("CircleLoss")
class CircleLoss(nn.Module):
    """Circle loss over the raw (unnormalized) similarities, its pair
    weights taken without gradient."""
    test_normalize = True

    def __init__(self, m: float = 0.25, gamma: float = 256.0):
        super().__init__()
        self.m, self.gamma = m, gamma

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feats, labels = flatten_grouped(x, label)
        sim = feats @ feats.T
        pos_mask, neg_mask = _upper_pair_masks(labels)
        sg = sim.detach()
        ap = torch.clamp(-sg + 1 + self.m, min=0.0)
        an = torch.clamp(sg + self.m, min=0.0)
        logit_p = -ap * (sim - (1 - self.m)) * self.gamma
        logit_n = an * (sim - self.m) * self.gamma
        ninf = float("-inf")
        lse_p = torch.logsumexp(
            torch.where(pos_mask, logit_p, _fill(logit_p, ninf)).reshape(-1),
            dim=0)
        lse_n = torch.logsumexp(
            torch.where(neg_mask, logit_n, _fill(logit_n, ninf)).reshape(-1),
            dim=0)
        z = lse_n + lse_p
        loss = torch.logaddexp(z, torch.zeros_like(z))       # softplus
        return loss, _nearest_same_label(sim, labels)


@LOSSES.register("CircleLossV2")
class CircleLossV2(nn.Module):
    """Circle loss as ``log1p(Σ pos · Σ neg)``, over cosines with
    ``similarity: cos`` (else raw dot products)."""
    test_normalize = True

    def __init__(self, scale: float = 32.0, margin: float = 0.25,
                 similarity: str = "cos"):
        super().__init__()
        self.scale, self.margin, self.similarity = scale, margin, similarity

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feats, labels = flatten_grouped(x, label)
        if self.similarity == "cos":
            feats = l2_normalize(feats, -1)
        sim = feats @ feats.T
        pos_mask, neg_mask = _upper_pair_masks(labels)
        alpha_p = torch.relu(-sim + 1 + self.margin)
        alpha_n = torch.relu(sim + self.margin)
        ep = torch.exp(-self.scale * alpha_p * (sim - (1 - self.margin)))
        en = torch.exp(self.scale * alpha_n * (sim - self.margin))
        loss_p = torch.sum(torch.where(pos_mask, ep, _fill(ep, 0.0)))
        loss_n = torch.sum(torch.where(neg_mask, en, _fill(en, 0.0)))
        return torch.log1p(loss_p * loss_n), _nearest_same_label(sim, labels)
