"""Pooling modules (port of ``models/pooling_extra.py``): attentive
(SAP), multi-head and double multi-head attention pooling, temporal
pyramid and global average pooling, dot-product self-attention, a graph
attention layer over the frames and top-k graph pooling.

Unlike the port's convolutional layers these take ``[B, T, C]``, as the
JAX modules do (every product here is a Dense or an einsum over C), and
return ``[B, ·]`` vectors (the graph layers: ``[B, T', ·]`` sequences).
Their own parameters keep the flax names and layouts (``v``, ``u``,
``a_src``, ``a_dst``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import promoted

__all__ = ["AttentionPooling", "MultiHeadAttentionPooling", "DoubleMHA",
           "TemporalPyramidPooling", "GlobalAveragePooling",
           "SimpleSelfAttention", "GraphAttentionLayer", "GraphPool"]


class AttentionPooling(nn.Module):
    """SAP: weights ``softmax_t(tanh(Dense(x)) · v)``, the weighted sum."""
    xavier_normal_params = ("v",)

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels)
        self.v = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(promoted(self.Dense_0, x))
        w = torch.softmax((h @ self.v)[..., 0], dim=1)
        return torch.sum(x * w[..., None], dim=1)


class MultiHeadAttentionPooling(nn.Module):
    """Per-head attention over ``heads`` channel splits, concatenated."""
    xavier_normal_params = ("v",)

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        if channels % heads:
            raise ValueError(f"channels {channels} not divisible by heads "
                             f"{heads}")
        self.heads = heads
        self.v = nn.Parameter(torch.zeros(heads, channels // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        xh = x.reshape(B, T, self.heads, C // self.heads)
        w = torch.softmax(torch.einsum("bthc,hc->bth", torch.tanh(xh),
                                       self.v), dim=1)
        return torch.einsum("bthc,bth->bhc", xh, w).reshape(B, C)


class DoubleMHA(nn.Module):
    """Multi-head pooling, then attention over the heads: ``[B, C/heads]``."""
    xavier_normal_params = ("v", "u")

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        hs = channels // heads
        self.v = nn.Parameter(torch.zeros(heads, hs))
        self.u = nn.Parameter(torch.zeros(hs, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        xh = x.reshape(B, T, self.heads, C // self.heads)
        w = torch.softmax(torch.einsum("bthc,hc->bth", torch.tanh(xh),
                                       self.v), dim=1)
        head_out = torch.einsum("bthc,bth->bhc", xh, w)       # [B, H, hs]
        hw = torch.softmax((torch.tanh(head_out) @ self.u)[..., 0], dim=1)
        return torch.einsum("bhc,bh->bc", head_out, hw)


class TemporalPyramidPooling(nn.Module):
    """Means over ``level`` equal segments (the tail cut), for each level,
    concatenated: ``[B, C·Σlevels]``."""

    def __init__(self, levels: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.levels = tuple(levels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        outs = []
        for lvl in self.levels:
            seg = T // lvl
            trimmed = x[:, :seg * lvl].reshape(B, lvl, seg, C)
            outs.append(trimmed.mean(dim=2).reshape(B, lvl * C))
        return torch.cat(outs, dim=-1)


class GlobalAveragePooling(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1)


class SimpleSelfAttention(nn.Module):
    """Scaled dot-product attention of ``Dense(x)`` against ``x``, the
    context averaged over time."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = promoted(self.Dense_0, x)
        scores = torch.einsum("btc,bsc->bts", q, x) / x.shape[-1] ** 0.5
        ctx = torch.einsum("bts,bsc->btc", torch.softmax(scores, dim=-1), x)
        return ctx.mean(dim=1)


class GraphAttentionLayer(nn.Module):
    """A GAT layer over the fully connected frame graph:
    ``e_ts = lrelu(h_t·a_src) + lrelu(h_s·a_dst)``, softmax over s, ELU of
    the aggregated ``h = Dense(x)`` (no bias)."""
    xavier_normal_params = ("a_src", "a_dst")

    def __init__(self, in_features: int, out_features: int,
                 alpha: float = 0.2):
        super().__init__()
        self.alpha = alpha
        self.Dense_0 = nn.Linear(in_features, out_features, bias=False)
        self.a_src = nn.Parameter(torch.zeros(out_features, 1))
        self.a_dst = nn.Parameter(torch.zeros(out_features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = promoted(self.Dense_0, x)                         # [B, T, F]
        e = (F.leaky_relu(h @ self.a_src, self.alpha)
             + F.leaky_relu(h @ self.a_dst, self.alpha).transpose(1, 2))
        att = torch.softmax(e, dim=-1)                        # [B, T, T]
        return F.elu(torch.einsum("bts,bsf->btf", att, h))


class GraphPool(nn.Module):
    """Top-k graph pooling: keeps the ``max(int(k·T), 1)`` frames of
    highest score ``Dense(x)`` (no bias), in descending score order, each
    gated by the sigmoid of its score."""

    def __init__(self, channels: int, k: float = 0.5):
        super().__init__()
        self.k = k
        self.Dense_0 = nn.Linear(channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        keep = max(int(x.shape[1] * self.k), 1)
        scores = promoted(self.Dense_0, x)[..., 0]            # [B, T]
        top_vals, top_idx = torch.topk(scores, keep, dim=1)
        gathered = torch.take_along_dim(x, top_idx[..., None], dim=1)
        return gathered * torch.sigmoid(top_vals)[..., None]
