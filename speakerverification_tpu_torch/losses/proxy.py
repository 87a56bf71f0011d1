"""Proxy heads (port of ``losses/proxy.py``): ``ProxyAnchor``,
``ProxyNCA``, ``MP``/``MMP`` (also registered as ``MP_Balance`` and
``MMP_Balance``) and ``MMP_Balance_MTL``.

The class proxies are ``proxies [nClasses, nOut]``, stored as they are
by the weight bridge; ``ProxyAnchor``, ``MP`` and ``MMP`` draw them
from flax's Kaiming fan-out normal (std ``sqrt(2 / nOut)``),
``ProxyNCA`` from a standard normal over 8. ``MP``/``MMP`` split each
speaker's utterances into a query (utterance 0) and an anchor (the mean
of the others), and put the anchors in place of their speakers'
proxies: they assume that no label repeats in a batch, as the
speaker-balanced sampler guarantees.
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
from speakerverification_tpu_torch.losses.margin import AmSoftmax
from speakerverification_tpu_torch.losses.proto import (
    _scalar_params,
    check_grouped,
)
from speakerverification_tpu_torch.models.layers import at_least_fp32
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["ProxyAnchor", "ProxyNCA", "MP", "MMP", "MMPBalanceMTL"]


def _proxies(n_classes: int, n_out: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(n_classes, n_out) * (2.0 / n_out) ** 0.5)


@LOSSES.register("ProxyAnchor")
class ProxyAnchor(nn.Module):
    """Log-sum-exp of the positive and negative cosine terms, the
    positive one averaged over the classes present in the batch."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.1, scale: float = 30.0):
        super().__init__()
        self.nClasses, self.margin, self.scale = nClasses, margin, scale
        self.proxies = _proxies(nClasses, nOut)
        self.normal_std_params = {"proxies": (2.0 / nOut) ** 0.5}

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        cos = promoted_matmul(l2_normalize(x, -1),
                              l2_normalize(self.proxies, -1).T)
        p_one_hot = F.one_hot(label.long(), self.nClasses).to(cos.dtype)
        n_one_hot = 1.0 - p_one_hot
        pos_exp = torch.exp(-self.scale * (cos - self.margin))
        neg_exp = torch.exp(self.scale * (cos + self.margin))
        with_pos = p_one_hot.sum(dim=0) > 0
        num_valid = torch.clamp(with_pos.sum(), min=1)
        p_sim = torch.sum(pos_exp * p_one_hot, dim=0)
        n_sim = torch.sum(neg_exp * n_one_hot, dim=0)
        pos_term = torch.sum(torch.where(
            with_pos, torch.log1p(p_sim), torch.zeros_like(p_sim))) / num_valid
        neg_term = torch.sum(torch.log1p(n_sim)) / self.nClasses
        return pos_term + neg_term, top1_percent(cos, label)


@LOSSES.register("ProxyNCA")
class ProxyNCA(nn.Module):
    """Cross-entropy with label smoothing over the negative squared
    distances between the scaled, normalized embeddings and proxies."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 smoothing_const: float = 0.1, scaling_x: float = 1.0,
                 scaling_p: float = 3.0):
        super().__init__()
        self.nClasses = nClasses
        self.smoothing_const = smoothing_const
        self.scaling_x, self.scaling_p = scaling_x, scaling_p
        self.proxies = nn.Parameter(torch.randn(nClasses, nOut) / 8.0)
        self.normal_std_params = {"proxies": 1.0 / 8.0}

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        P = l2_normalize(self.proxies, -1) * self.scaling_p
        X = l2_normalize(x, -1) * self.scaling_x
        d2 = (torch.sum(X ** 2, -1)[:, None] + torch.sum(P ** 2, -1)[None, :]
              - 2.0 * promoted_matmul(X, P.T))
        T = F.one_hot(label.long(), self.nClasses).to(d2.dtype) \
            * (1 - self.smoothing_const)
        T = torch.where(T == 0, torch.full_like(
            T, self.smoothing_const / (self.nClasses - 1)), T)
        loss = torch.mean(torch.sum(-T * F.log_softmax(-d2, dim=-1), -1))
        return loss, top1_percent(-d2, label)


def _query_anchor(x: torch.Tensor, head: str):
    """Grouped ``[B, nPer, D]`` → (utterance 0, the mean of the rest)."""
    check_grouped(x, head)
    anchor = at_least_fp32(x[:, 1:, :]).mean(dim=1).to(x.dtype)
    return x[:, 0, :], anchor


class _MultiProxy(nn.Module):
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 w_init: float = 10.0, b_init: float = -5.0,
                 lambda_init: float = 0.5):
        super().__init__()
        self.nClasses, self.lambda_init = nClasses, lambda_init
        self.proxies = _proxies(nClasses, nOut)
        self.normal_std_params = {"proxies": (2.0 / nOut) ** 0.5}
        self.w, self.b = _scalar_params(w_init, b_init)


@LOSSES.register("MP")
class MP(_MultiProxy):
    """Cross-entropy of each query against the proxy bank with the
    batch's anchors in place, plus ``lambda_init`` times the anchors'
    cross-entropy against their own proxies (its prec1)."""

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        query, anchor = _query_anchor(x, "MP")
        label = label.long()
        P = l2_normalize(self.proxies, -1)
        new_center = P.index_put((label,), anchor)
        logits = promoted_matmul(query, new_center.T) * self.w + self.b
        loss1 = cross_entropy(logits, label)
        logits2 = promoted_matmul(anchor, P[label].T) * self.w + self.b
        idx = torch.arange(x.shape[0], device=x.device)
        loss2 = cross_entropy(logits2, idx)
        return loss1 + self.lambda_init * loss2, top1_percent(logits2, idx)


@LOSSES.register("MMP")
class MMP(_MultiProxy):
    """Pulls each query to its own (in-batch) centre, pushes it from the
    proxies out of the batch and from the other in-batch centres, plus
    ``lambda_init`` times the anchors' cross-entropy (its prec1)."""

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        query, anchor = _query_anchor(x, "MMP")
        label = label.long()
        w, b = self.w, self.b
        P = l2_normalize(self.proxies, -1)
        new_center = P.index_put((label,), l2_normalize(anchor, -1))
        own_center = new_center[label]
        own = torch.sum(query * own_center, dim=1)
        l1 = torch.log1p(torch.sum(torch.exp(-own * w + b)))
        all_logits = promoted_matmul(query, new_center.T) * w - b
        in_batch = torch.zeros(self.nClasses, dtype=torch.bool,
                               device=x.device)
        in_batch[label] = True
        e = torch.exp(all_logits)
        l2 = torch.mean(torch.log1p(torch.sum(
            torch.where(in_batch[None, :], torch.zeros_like(e), e), dim=1)))
        z = torch.exp(promoted_matmul(query, own_center.T) * w - b)
        l3 = torch.mean(torch.log1p(torch.sum(z, dim=1) - torch.diagonal(z)))
        logits2 = promoted_matmul(anchor, P[label].T) * w - b
        idx = torch.arange(x.shape[0], device=x.device)
        loss_reg = cross_entropy(logits2, idx)
        return (l1 + l2 + l3 + self.lambda_init * loss_reg,
                top1_percent(logits2, idx))


# the *_Balance names take the grouped batch as MP/MMP do (the same under
# the speaker-balanced sampler, which never repeats a speaker in a batch)
LOSSES.register("MP_Balance")(MP)
LOSSES.register("MMP_Balance")(MMP)


@LOSSES.register("MMP_Balance_MTL")
class MMPBalanceMTL(nn.Module):
    """``(1 - weight)·AmSoftmax + weight·MMP``; prec1 of the AmSoftmax
    head (flax's auto-names ``AmSoftmax_0``, ``MMP_0``)."""
    test_normalize = True

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.1, scale: float = 30.0,
                 weight: float = 0.6):
        super().__init__()
        self.weight = weight
        self.AmSoftmax_0 = AmSoftmax(nOut, nClasses, margin, scale)
        self.MMP_0 = MMP(nOut, nClasses)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        loss_ce, prec1 = self.AmSoftmax_0(x, label)
        loss_ml, _ = self.MMP_0(x, label)
        return (1 - self.weight) * loss_ce + self.weight * loss_ml, prec1
