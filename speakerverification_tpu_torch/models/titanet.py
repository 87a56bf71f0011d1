"""TitaNet speaker encoder (port of ``models/titanet.py``).

A prolog ``ConvBlock1d`` (k=3) → N mega blocks (three depthwise-separable
conv sub-blocks, a bias-free SE/16, a 1×1 conv + BN skip, ReLU, dropout)
→ an epilog ``ConvBlock1d`` (1×1 to 1536) → attentive statistics pooling
with per-channel energies → BN → linear → BN. Sizes: S (hidden 256, k 3),
M (512, k 7), L (1024, k 11); the default depth is the JAX builder's
parameter-count search (:func:`find_n_mega_blocks`), which depends on the
embedding width. ``[B, frames, F] -> [B, nOut]``; inside, ``[B, C, T]``.

The pooling's Dense layers act on the time-major view ``[B, T, C]`` as
``nn.Linear``s (the JAX module's ``nn.Dense``), so int8 keys and
predicates match; the depthwise convs (``groups = C``) stay float. Dropout
(0.5) draws its masks from the ``torch.Generator`` given to ``forward``
(``draws_dropout``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from speakerverification_tpu_torch.models.layers import (
    Dropout,
    batch_norm,
    bn_module,
    feature_dim,
    promoted,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["ConvBlock1d", "MegaBlock", "TitaNet", "SIZES",
           "titanet_param_count", "find_n_mega_blocks", "build_titanet"]


class ConvBlock1d(nn.Module):
    """(Depthwise-separable) conv → BN → ReLU [→ dropout]. 'SAME' padding;
    depthwise: a ``groups = C`` conv (``Conv_0``) then a 1×1 conv
    (``Conv_1``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 depthwise: bool = False, dropout: float = 0.0):
        super().__init__()
        if depthwise:
            self.Conv_0 = nn.Conv1d(in_channels, in_channels, kernel_size,
                                    padding="same", groups=in_channels)
            self.Conv_1 = nn.Conv1d(in_channels, features, 1)
        else:
            self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                    padding="same")
        self.depthwise = depthwise
        self.BatchNorm_0 = bn_module(features)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        x = promoted(self.Conv_0, x)
        if self.depthwise:
            x = promoted(self.Conv_1, x)
        x = torch.relu(batch_norm(self.BatchNorm_0, x))
        return self.drop(x, rng)


class MegaBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 n_sub_blocks: int = 3, se_reduction: int = 16,
                 dropout: float = 0.5):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, features, 1)
        self.BatchNorm_0 = bn_module(features)
        self.n_sub = n_sub_blocks
        for i in range(n_sub_blocks):
            self.add_module(f"ConvBlock1d_{i}", ConvBlock1d(
                in_channels if i == 0 else features, features, kernel_size,
                depthwise=True, dropout=dropout))
        self.Dense_0 = nn.Linear(features, features // se_reduction,
                                 bias=False)
        self.Dense_1 = nn.Linear(features // se_reduction, features,
                                 bias=False)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        skip = batch_norm(self.BatchNorm_0, promoted(self.Conv_0, x))
        h = x
        for i in range(self.n_sub):
            h = getattr(self, f"ConvBlock1d_{i}")(h, rng)
        # squeeze-excitation over time
        s = torch.relu(promoted(self.Dense_0, h.mean(dim=2)))
        s = torch.sigmoid(promoted(self.Dense_1, s))
        return self.drop(torch.relu(skip + h * s[:, :, None]), rng)


class TitaNet(nn.Module):
    draws_dropout = True

    def __init__(self, n_mels: int = 80, nOut: int = 192,
                 hidden_size: int = 256, mega_block_kernel: int = 3,
                 n_mega_blocks: int = 6, n_sub_blocks: int = 3,
                 encoder_output_size: int = 1536,
                 attention_hidden_size: int = 128, dropout: float = 0.5):
        super().__init__()
        self.n_mega = n_mega_blocks
        self.ConvBlock1d_0 = ConvBlock1d(n_mels, hidden_size, 3)
        for i in range(n_mega_blocks):
            self.add_module(f"MegaBlock_{i}", MegaBlock(
                hidden_size, hidden_size, mega_block_kernel, n_sub_blocks,
                dropout=dropout))
        self.ConvBlock1d_1 = ConvBlock1d(hidden_size, encoder_output_size, 1)
        # flax names the outer Dense of ``Dense(C)(tanh(Dense(A)(h)))``
        # first: Dense_1 runs before Dense_0
        self.Dense_0 = nn.Linear(attention_hidden_size, encoder_output_size)
        self.Dense_1 = nn.Linear(encoder_output_size, attention_hidden_size)
        self.BatchNorm_0 = bn_module(2 * encoder_output_size)
        self.Dense_2 = nn.Linear(2 * encoder_output_size, nOut)
        self.BatchNorm_1 = bn_module(nOut)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: features ``[B, frames, F]`` → ``[B, nOut]``; ``rng``
        draws the dropout masks of a training forward."""
        h = self.ConvBlock1d_0(x.transpose(1, 2), rng)
        for i in range(self.n_mega):
            h = getattr(self, f"MegaBlock_{i}")(h, rng)
        h = self.ConvBlock1d_1(h, rng).transpose(1, 2)       # [B, T, C]
        e = promoted(self.Dense_0, torch.tanh(promoted(self.Dense_1, h)))
        alphas = torch.softmax(e, dim=1)                     # over time
        means = torch.sum(alphas * h, dim=1)
        stds = torch.sqrt(torch.clamp(
            torch.sum(alphas * h * h, dim=1) - means * means, min=1e-6))
        pooled = batch_norm(self.BatchNorm_0, torch.cat([means, stds], -1))
        return batch_norm(self.BatchNorm_1, promoted(self.Dense_2, pooled))


SIZES = {"s": (256, 3), "m": (512, 7), "l": (1024, 11)}
_TARGET_PARAMS = {"s": 6.4, "m": 13.4, "l": 25.3}


def titanet_param_count(emb: int, n_mels: int, n_mega: int,
                        size: str = "m", n_sub: int = 3,
                        attention_hidden: int = 128,
                        output_size: int = 1536) -> int:
    """The reference TitaNet's parameter count in closed form: prolog
    conv + BN, ``n_mega`` mega blocks (``n_sub`` depthwise-separable conv
    + BN sub-blocks, bias-free SE/16, 1×1 + BN skip), epilog, the
    attentive-pooling decoder."""
    h, k = SIZES[size]
    o, a = output_size, attention_hidden
    prolog = 3 * n_mels * h + 3 * h
    mega = (n_sub * (h * h + k * h + 4 * h)
            + 2 * h * (h // 16)
            + h * h + 3 * h)
    epilog = h * o + 3 * o
    dec = 2 * a * o + a + 5 * o + 2 * o * emb + 3 * emb
    return prolog + n_mega * mega + epilog + dec


def find_n_mega_blocks(emb: int, n_mels: int, size: str) -> int:
    """The depth in 1..19 whose parameter count is closest to the size's
    budget (6.4 / 13.4 / 25.3 M; the first of equals): 'm' gives 10 blocks
    at emb 192, 11 at emb 64."""
    target = _TARGET_PARAMS[size] * 1e6
    best, best_d = 1, float("inf")
    for n in range(1, 20):
        d = abs(titanet_param_count(emb, n_mels, n, size) - target)
        if d < best_d:
            best, best_d = n, d
    return best


@MODELS.register("TitaNet")
def build_titanet(nOut: int = 512, model_size: str = "l",
                  n_mega_blocks: Optional[int] = None, **kwargs) -> TitaNet:
    """TitaNet of ``model_size`` (default L); the depth searched from the
    config's ``n_mels`` unless ``n_mega_blocks`` is given."""
    size = model_size.lower()
    hidden, kernel = SIZES[size]
    n_mels = int(kwargs.get("n_mels", 80))
    return TitaNet(n_mels=feature_dim(kwargs), nOut=nOut, hidden_size=hidden,
                   mega_block_kernel=kernel,
                   n_mega_blocks=(n_mega_blocks
                                  or find_n_mega_blocks(nOut, n_mels, size)))
