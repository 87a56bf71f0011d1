"""Triplet loss with negatives mined in the batch (port of
``losses/triplet.py``).

``x [B, 2, D]``: anchors are utterance 0, positives utterance 1, both
L2-normalized; the loss is the hinge ``relu(|a - p|² - |a - n|² +
margin)`` averaged over the batch, and prec1 the share of triplets
whose positive is nearer than the negative by the margin. A negative is
another speaker's positive: with ``hard_rank < 0`` a random semi-hard
one (a random other one where none is semi-hard), else with probability
``hard_prob`` one of the ``hard_rank`` most similar, otherwise a uniform
draw among the others.

The JAX head draws from its ``mining`` rng when the caller gives one and
from ``PRNGKey(0)`` otherwise; its train step gives none, so every step
of JAX training mines with the same key. The port keeps that: each call
draws from a fresh generator seeded with 0 on the embeddings' device.
jax.random's stream cannot be reproduced in torch, so the draws differ
from JAX's; :func:`triplet_from_indices` computes the loss of given
negatives, which is what the two packages share.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from speakerverification_tpu_torch.losses.common import l2_normalize
from speakerverification_tpu_torch.losses.proto import check_grouped
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["TripletLoss", "triplet_from_indices", "mine_negatives"]

MINING_SEED = 0


def triplet_from_indices(anchor: torch.Tensor, positive: torch.Tensor,
                         negidx: torch.Tensor, margin: float):
    """``(loss, prec1)`` of the triplets ``(anchor_i, positive_i,
    positive[negidx_i])`` (normalized embeddings)."""
    negative = positive[negidx.long()]
    pos_d2 = torch.sum((anchor - positive) ** 2, dim=-1)
    neg_d2 = torch.sum((anchor - negative) ** 2, dim=-1)
    loss = torch.mean(torch.relu(pos_d2 - neg_d2 + margin))
    prec = 100.0 * (pos_d2 + margin < neg_d2).float().mean()
    return loss, prec


@torch.no_grad()
def mine_negatives(sim: torch.Tensor, hard_rank: int, hard_prob: float,
                   margin: float, generator: torch.Generator) -> torch.Tensor:
    """The negative's index for each row of ``sim [B, B]`` (the negative
    squared distances of anchors to positives), drawn from
    ``generator``."""
    B = sim.shape[0]
    dev = sim.device
    eye = torch.eye(B, dtype=torch.bool, device=dev)
    if hard_rank < 0:
        own = torch.diagonal(sim)
        semi = ~eye & (sim > (own - margin)[:, None]) & (sim < own[:, None])
        u = torch.rand((B, B), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(u.dtype).tiny)))
        ninf = torch.full_like(gumbel, float("-inf"))
        scores = torch.where(semi, torch.zeros_like(gumbel), ninf)
        fallback = torch.where(eye, ninf, gumbel)
        return torch.where(semi.any(dim=1),
                           torch.argmax(scores + gumbel, dim=1),
                           torch.argmax(fallback, dim=1))
    order = torch.argsort(-torch.where(eye, torch.full_like(
        sim, float("-inf")), sim), dim=1, stable=True)
    k = torch.randint(0, max(hard_rank, 1), (B,), generator=generator,
                      device=dev)
    hard = order.gather(1, k[:, None])[:, 0]
    rand = torch.randint(0, B - 1, (B,), generator=generator, device=dev)
    rand = torch.where(rand >= torch.arange(B, device=dev), rand + 1, rand)
    use_hard = torch.rand((B,), generator=generator, device=dev) < hard_prob
    return torch.where(use_hard, hard, rand)


@LOSSES.register("TripletLoss")
class TripletLoss(nn.Module):
    test_normalize = True

    def __init__(self, hard_rank: int = 0, hard_prob: float = 0.0,
                 margin: float = 0.2):
        super().__init__()
        self.hard_rank, self.hard_prob, self.margin = \
            hard_rank, hard_prob, margin

    def forward(self, x: torch.Tensor, label=None):
        check_grouped(x, "TripletLoss", exactly=2)
        anchor = l2_normalize(x[:, 0, :], -1)
        positive = l2_normalize(x[:, 1, :], -1)
        d2 = (torch.sum(anchor ** 2, -1)[:, None]
              + torch.sum(positive ** 2, -1)[None, :]
              - 2.0 * anchor @ positive.T)
        gen = torch.Generator(device=x.device).manual_seed(MINING_SEED)
        negidx = mine_negatives(-d2, self.hard_rank, self.hard_prob,
                                self.margin, gen)
        return triplet_from_indices(anchor, positive, negidx, self.margin)
