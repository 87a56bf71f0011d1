"""Conformer speaker encoders (port of ``models/conformer.py``).

* ``Conformer`` (:class:`ConformerSpeaker`): instance-normed log-mel →
  a Conv2d-subsampled stack of conformer blocks (dim 256, 6 blocks,
  depthwise kernel 15) → conv attentive statistics pooling → BatchNorm →
  Dense.
* ``ECAPA_Conformer`` (:class:`ECAPAConformer`): the ECAPA TDNN /
  SE-Res2Net trunk with feature aggregation → a 16-block conformer at
  dim 144, depthwise kernel 31 → attentive statistics pooling →
  BatchNorm → Dense. Its SE-Res2Net blocks take the plain convs, as the
  JAX builder passes no ``conv_backend``.

Both take features ``[B, frames, n_mels]`` and return ``[B, nOut]``.
Inside the conformer the activations stay ``[B, T, C]``, as in the JAX
package, so its products are ``nn.Linear`` Denses (the int8 path
quantizes them on K3's Dense route); the subsampling convs and the
depthwise conv run channels-first. Blocks use Transformer-XL relative
attention with the JAX module's quirks: scores scaled by √d_model, the
positional term from pe[0..T−1] (interleaved sin/cos) through a
bias-free Dense before the shift.

Every Dense, conv and LayerNorm computes in the promoted type of its
input and weights, as flax does. The positional encoding is fp32, so
with bf16 weights the attention's positional score, and the residual
stream after the first attention, are fp32.

Dropout (rate 0.1) draws its masks from the ``torch.Generator`` given to
``forward`` (``rng``); a training forward without one raises. In eval
it is off, as ``deterministic=not train`` is in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import (
    AttentiveStatisticsPooling,
    BatchNorm1d,
    Dropout,
    SERes2NetBlock,
    TDNNBlock,
    at_least_fp32,
    batch_norm,
    bn_module,
    feature_dim,
    gelu_exact,
    promoted,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["sinusoidal_pe", "relative_shift", "Dropout", "layer_norm",
           "RelativeMultiHeadAttention", "MHSAModule", "FeedForward",
           "ConvModule", "ConformerBlock", "ConformerEncoder",
           "ConformerSpeaker", "ECAPAConformer", "build_conformer",
           "build_ecapa_conformer"]

# flax nn.LayerNorm's epsilon (torch's default is 1e-5)
LN_EPS = 1e-6
# the JAX modules' settings, which no builder changes: 4 heads, the
# feed-forward's ×4 and the conv module's ×2 (the GLU's doubling)
# expansions, dropout 0.1, half-step feed-forward residuals
HEADS, FF_EXPANSION, DROPOUT = 4, 4, 0.1


def sinusoidal_pe(T: int, d: int, device=None) -> torch.Tensor:
    """Interleaved sin/cos positional encoding ``[T, d]`` in fp32:
    column ``2i`` is ``sin``, ``2i + 1`` is ``cos``."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    angle = pos * div[None, :]                                  # [T, d/2]
    return torch.stack([torch.sin(angle), torch.cos(angle)],
                       dim=-1).reshape(T, d)


def relative_shift(pos_score: torch.Tensor) -> torch.Tensor:
    """Transformer-XL shift of ``[B, H, T, S]`` scores: one zero column
    in front, rows re-cut to ``S + 1``, the first dropped."""
    B, H, T, S = pos_score.shape
    padded = F.pad(pos_score, (1, 0))
    return padded.reshape(B, H, S + 1, T)[:, :, 1:].reshape(B, H, T, S)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln`` over the last axis as flax's ``nn.LayerNorm`` computes it:
    statistics and affine in fp32 at least, the result in the promoted
    type of x and the parameters."""
    xf = at_least_fp32(x)
    y = F.layer_norm(xf, ln.normalized_shape, ln.weight.to(xf.dtype),
                     ln.bias.to(xf.dtype), ln.eps)
    dt = torch.promote_types(torch.promote_types(x.dtype, ln.weight.dtype),
                             ln.bias.dtype)
    return y.to(dt)


def _layer_norm_module(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of both, as ``jnp.einsum`` takes a
    bf16 and an fp32 operand."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL relative multi-head attention over ``[B, T, dim]``:
    ``Dense_0..2`` are q, k, v, ``Dense_3`` the bias-free positional
    projection, ``Dense_4`` the output."""

    # drawn by weights.init_weights_ as flax's xavier_uniform over (H, Dh)
    xavier_uniform_params = ("u_bias", "v_bias")

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        head = dim // HEADS
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.Dense_2 = nn.Linear(dim, dim)
        self.Dense_3 = nn.Linear(dim, dim, bias=False)
        self.u_bias = nn.Parameter(torch.zeros(HEADS, head))
        self.v_bias = nn.Parameter(torch.zeros(HEADS, head))
        self.Dense_4 = nn.Linear(dim, dim)
        self.drop = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = x.shape
        H = HEADS
        Dh = self.dim // H
        q = promoted(self.Dense_0, x).reshape(B, T, H, Dh)
        k = promoted(self.Dense_1, x).reshape(B, T, H, Dh)
        v = promoted(self.Dense_2, x).reshape(B, T, H, Dh)
        p = promoted(self.Dense_3, pos).reshape(1, T, H, Dh)

        # [B, H, T, Dh] @ [B, H, Dh, S] -> [B, H, T, S]
        content = _matmul((q + self.u_bias).transpose(1, 2),
                          k.permute(0, 2, 3, 1))
        pos_score = relative_shift(_matmul((q + self.v_bias).transpose(1, 2),
                                           p.permute(0, 2, 3, 1)))
        score = (content + pos_score) / math.sqrt(self.dim)
        attn = self.drop(torch.softmax(score, dim=-1), rng)
        ctx = _matmul(attn, v.transpose(1, 2))                 # [B, H, T, Dh]
        return promoted(self.Dense_4,
                        ctx.transpose(1, 2).reshape(B, T, self.dim))


class MHSAModule(nn.Module):
    """Pre-LN relative attention with dropout after it."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.LayerNorm_0 = _layer_norm_module(dim)
        self.RelativeMultiHeadAttention_0 = RelativeMultiHeadAttention(dim)
        self.drop = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        pos = sinusoidal_pe(x.shape[1], self.dim, x.device)[None]
        h = layer_norm(self.LayerNorm_0, x)
        h = self.RelativeMultiHeadAttention_0(h, pos, rng)
        return self.drop(h, rng)


class FeedForward(nn.Module):
    """LN → Dense(4·dim) → swish → dropout → Dense(dim) → dropout (the JAX
    ``_FeedForward``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = _layer_norm_module(dim)
        self.Dense_0 = nn.Linear(dim, dim * FF_EXPANSION)
        self.Dense_1 = nn.Linear(dim * FF_EXPANSION, dim)
        self.drop = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.silu(promoted(self.Dense_0, layer_norm(self.LayerNorm_0, x)))
        h = promoted(self.Dense_1, self.drop(h, rng))
        return self.drop(h, rng)


class ConvModule(nn.Module):
    """LN → pointwise Dense(2·dim) → GLU → bias-free depthwise conv
    ('SAME') → BatchNorm → swish → pointwise Dense(dim) → dropout (the
    JAX ``_ConvModule``)."""

    def __init__(self, dim: int, kernel_size: int = 31):
        super().__init__()
        self.LayerNorm_0 = _layer_norm_module(dim)
        self.Dense_0 = nn.Linear(dim, 2 * dim)
        self.Conv_0 = nn.Conv1d(dim, dim, kernel_size, padding="same",
                                groups=dim, bias=False)
        self.BatchNorm_0 = bn_module(dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.drop = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = promoted(self.Dense_0, layer_norm(self.LayerNorm_0, x))
        a, b = h.chunk(2, dim=-1)
        h = promoted(self.Conv_0, (a * torch.sigmoid(b)).transpose(1, 2))
        h = F.silu(batch_norm(self.BatchNorm_0, h)).transpose(1, 2)
        return self.drop(promoted(self.Dense_1, h), rng)


class ConformerBlock(nn.Module):
    """Half-step feed-forward → attention → conv module → half-step
    feed-forward, each residual, then LayerNorm."""

    def __init__(self, dim: int, conv_kernel: int = 31):
        super().__init__()
        self.add_module("_FeedForward_0", FeedForward(dim))
        self.MHSAModule_0 = MHSAModule(dim)
        self.add_module("_ConvModule_0", ConvModule(dim, conv_kernel))
        self.add_module("_FeedForward_1", FeedForward(dim))
        self.LayerNorm_0 = _layer_norm_module(dim)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + 0.5 * self._FeedForward_0(x, rng)
        x = x + self.MHSAModule_0(x, rng)
        x = x + self._ConvModule_0(x, rng)
        x = x + 0.5 * self._FeedForward_1(x, rng)
        return layer_norm(self.LayerNorm_0, x)


class ConformerEncoder(nn.Module):
    """Conformer stack over ``[B, T, in_features]``: two 3×3 stride-2
    'VALID' Conv2d + ReLU over ``[B, 1, T, F]`` (×4 in time and in
    features), flattened ``F' · C`` with C fastest as the JAX package
    flattens ``[B, T, F, C]``, ``Dense_0`` to the encoder width, then the
    blocks."""

    def __init__(self, in_features: int, encoder_dim: int = 256,
                 num_layers: int = 6, conv_kernel: int = 31):
        super().__init__()
        self.num_layers = num_layers
        self.Conv_0 = nn.Conv2d(1, encoder_dim, 3, stride=2)
        self.Conv_1 = nn.Conv2d(encoder_dim, encoder_dim, 3, stride=2)
        f = ((in_features - 3) // 2 + 1 - 3) // 2 + 1
        self.Dense_0 = nn.Linear(f * encoder_dim, encoder_dim)
        self.drop = Dropout(DROPOUT)
        for i in range(num_layers):
            self.add_module(f"ConformerBlock_{i}",
                            ConformerBlock(encoder_dim, conv_kernel))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(promoted(self.Conv_0, x[:, None]))
        h = torch.relu(promoted(self.Conv_1, h))                # [B, C, T, F]
        B, C, T, Fq = h.shape
        x = h.permute(0, 2, 3, 1).reshape(B, T, Fq * C)
        h = self.drop(promoted(self.Dense_0, x), rng)
        for i in range(self.num_layers):
            h = getattr(self, f"ConformerBlock_{i}")(h, rng)
        return h


def _log_instance_norm(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Log-compressed, time-centred mel (for mel features), then the
    affine instance norm over time with biased variance, eps 1e-5."""
    if module.feature_type == "melspectrogram":
        x = torch.log(torch.clamp(x, min=0.0) + 1e-6)
        x = x - x.mean(dim=1, keepdim=True)
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * module.inorm_scale \
        + module.inorm_bias


class ConformerSpeaker(nn.Module):
    """The ``Conformer`` model: features ``[B, frames, n_mels]`` →
    ``[B, nOut]``."""

    # SpeakerEncoder hands such a backbone the forward's generator
    draws_dropout = True

    def __init__(self, n_mels: int = 80, nOut: int = 512,
                 encoder_dim: int = 256, num_layers: int = 6,
                 feature_type: str = "melspectrogram"):
        super().__init__()
        self.feature_type = feature_type
        self.inorm_scale = nn.Parameter(torch.ones(n_mels))
        self.inorm_bias = nn.Parameter(torch.zeros(n_mels))
        self.ConformerEncoder_0 = ConformerEncoder(n_mels, encoder_dim,
                                                   num_layers, conv_kernel=15)
        # the pooling's attention: 128 channels
        self.Conv_0 = nn.Conv1d(encoder_dim, 128, 1)
        self.BatchNorm_0 = bn_module(128)
        self.Conv_1 = nn.Conv1d(128, encoder_dim, 1)
        self.BatchNorm_1 = bn_module(2 * encoder_dim)
        self.Dense_0 = nn.Linear(2 * encoder_dim, nOut)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _log_instance_norm(self, x)
        h = self.ConformerEncoder_0(x, rng).transpose(1, 2)     # [B, C, T]
        attn = torch.relu(promoted(self.Conv_0, h))
        attn = promoted(self.Conv_1, batch_norm(self.BatchNorm_0, attn))
        wgt = torch.softmax(attn, dim=2)
        mu = torch.sum(h * wgt, dim=2)
        sg = torch.sqrt(torch.clamp(torch.sum(h ** 2 * wgt, dim=2) - mu ** 2,
                                    1e-4, 1e4))
        pooled = batch_norm(self.BatchNorm_1, torch.cat([mu, sg], dim=-1))
        return promoted(self.Dense_0, pooled)


class ECAPAConformer(nn.Module):
    """The ``ECAPA_Conformer`` model: features ``[B, frames, n_mels]`` →
    ``[B, nOut]``."""

    draws_dropout = True

    def __init__(self, n_mels: int = 80, nOut: int = 192,
                 channels: Sequence[int] = (512, 512, 512, 512, 1536),
                 kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
                 dilations: Sequence[int] = (1, 2, 3, 4, 1),
                 res2net_scale: int = 8, se_channels: int = 128,
                 attention_channels: int = 128, encoder_dim: int = 144,
                 num_layers: int = 16, feature_type: str = "melspectrogram"):
        super().__init__()
        if not len(channels) == len(kernel_sizes) == len(dilations):
            raise ValueError("channels, kernel_sizes and dilations differ "
                             "in length")
        self.feature_type = feature_type
        self.inorm_scale = nn.Parameter(torch.ones(n_mels))
        self.inorm_bias = nn.Parameter(torch.zeros(n_mels))
        self.TDNNBlock_0 = TDNNBlock(n_mels, channels[0], kernel_sizes[0],
                                     dilations[0], activation=gelu_exact)
        self.n_blocks = len(channels) - 2
        for i in range(1, len(channels) - 1):
            self.add_module(f"SERes2NetBlock_{i - 1}", SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale=res2net_scale,
                se_channels=se_channels, kernel_size=kernel_sizes[i],
                dilation=dilations[i], activation=gelu_exact))
        self.TDNNBlock_1 = TDNNBlock(sum(channels[1:-1]), channels[-1],
                                     kernel_sizes[-1], dilations[-1],
                                     activation=gelu_exact)
        self.ConformerEncoder_0 = ConformerEncoder(channels[-1], encoder_dim,
                                                   num_layers, conv_kernel=31)
        self.AttentiveStatisticsPooling_0 = AttentiveStatisticsPooling(
            encoder_dim, attention_channels)
        self.BatchNorm1d_0 = BatchNorm1d(2 * encoder_dim)
        self.Dense_0 = nn.Linear(2 * encoder_dim, nOut)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.TDNNBlock_0(_log_instance_norm(self, x).transpose(1, 2))
        outs = []
        for i in range(self.n_blocks):
            x = getattr(self, f"SERes2NetBlock_{i}")(x, lengths)
            outs.append(x)
        x = self.TDNNBlock_1(torch.cat(outs, dim=1))            # [B, C, T]
        x = self.ConformerEncoder_0(x.transpose(1, 2), rng)     # [B, T, D]
        x = self.AttentiveStatisticsPooling_0(x.transpose(1, 2), lengths)
        return promoted(self.Dense_0, self.BatchNorm1d_0(x))


def _feature_type(kwargs) -> str:
    return kwargs.get("feature_type", kwargs.get("features",
                                                 "melspectrogram"))


@MODELS.register("Conformer")
def build_conformer(nOut: int = 512, **kwargs) -> ConformerSpeaker:
    """Factory keyed by ``model.name: Conformer`` (``encoder_dim`` and
    ``num_layers`` taken from the model keys, as in JAX)."""
    return ConformerSpeaker(n_mels=feature_dim(kwargs), nOut=nOut,
                            feature_type=_feature_type(kwargs),
                            encoder_dim=int(kwargs.get("encoder_dim", 256)),
                            num_layers=int(kwargs.get("num_layers", 6)))


@MODELS.register("ECAPA_Conformer")
def build_ecapa_conformer(nOut: int = 192, **kwargs) -> ECAPAConformer:
    """Factory keyed by ``model.name: ECAPA_Conformer``; like the JAX
    builder it ignores ``conv_backend``."""
    known = {k: tuple(kwargs[k]) for k in ("channels", "kernel_sizes",
                                           "dilations") if k in kwargs}
    return ECAPAConformer(n_mels=feature_dim(kwargs), nOut=nOut,
                          feature_type=_feature_type(kwargs),
                          encoder_dim=int(kwargs.get("encoder_dim", 144)),
                          num_layers=int(kwargs.get("num_layers", 16)),
                          **known)
