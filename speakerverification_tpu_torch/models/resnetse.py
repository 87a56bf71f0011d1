"""Thin-ResNet SE speaker encoders over mel images (port of
``models/resnetse.py``).

Log + CMN + non-affine instance norm of the features (``log_input``, on
for ``melspectrogram``), a 3×3 stem (conv → ReLU → BN), four groups of SE
blocks with stride 2 from the second group on, the frequency axis
flattened into the channels, attentive pooling over time (``ASP`` or
``SAP``) and a linear embedding. ``[B, frames, F] -> [B, nOut]``.

Inside, the image is channels-first ``[B, C, F, T]`` (the JAX module's is
``[B, F, T, C]``): the flatten to ``[B, C·F, T]``, F fastest, is then a
plain reshape, the order of the JAX module's ``[B, T, C·F]``. The
attention convs are ``nn.Conv1d`` k=1 and the SE excitations
``nn.Linear``, as the JAX module's ``nn.Conv``/``nn.Dense``, so int8 keys
and predicates match (``Conv_1`` and ``Dense_0`` are K3 layers at the
registered widths).

Two SE variants, as in the JAX module: the basic block's bias-free
``c/16`` excitation, and the biased one with a fixed 16-wide squeeze of
``SEBasicBlockV2`` and ``SEBottleneck``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn

from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
    feature_dim,
    promoted,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["SELayer", "SEBasicBlock", "SEBasicBlockV2", "SEBottleneck",
           "ResNetSE", "log_cmn_instance_norm", "conv3x3", "conv1x1"]

Stride = Union[int, Tuple[int, int]]


def conv3x3(cin: int, cout: int, stride: Stride = 1,
            bias: bool = False) -> nn.Conv2d:
    """3×3 conv with the explicit (1, 1) padding of the JAX modules."""
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, stride: Stride = 1) -> nn.Conv2d:
    """Bias-free 1×1 shortcut conv ('SAME' at k=1 pads nothing)."""
    return nn.Conv2d(cin, cout, 1, stride, bias=False)


def _strided(stride: Stride) -> bool:
    return stride not in (1, (1, 1))


def log_cmn_instance_norm(x: torch.Tensor, log_input: bool) -> torch.Tensor:
    """``[B, T, F]``: log(max(x, 0) + 1e-6) minus its mean over time when
    ``log_input``, then each feature normalized over time (biased
    variance, eps 1e-5, no affine)."""
    if log_input:
        x = torch.log(torch.clamp(x, min=0.0) + 1e-6)
        x = x - x.mean(dim=1, keepdim=True)
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


class SELayer(nn.Module):
    """Squeeze-excitation over ``[B, C, H, W]``: the mean over H and W,
    ReLU(``Dense_0``), sigmoid(``Dense_1``), a per-channel scale. Width
    ``internal`` when > 0, else ``max(C // reduction, 1)``."""

    def __init__(self, channels: int, reduction: int = 16,
                 internal: int = 0, use_bias: bool = False):
        super().__init__()
        width = internal if internal > 0 else max(channels // reduction, 1)
        self.Dense_0 = nn.Linear(channels, width, bias=use_bias)
        self.Dense_1 = nn.Linear(width, channels, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3))
        y = torch.relu(promoted(self.Dense_0, y))
        y = torch.sigmoid(promoted(self.Dense_1, y))
        return x * y[:, :, None, None]


class _Shortcut(nn.Module):
    """The residual: ``x``, or a 1×1 conv + BN where the stride or the
    width changes (``Conv_{n}``/``BatchNorm_{n}``, numbered after the
    block's own)."""

    def _shortcut(self, n: int, cin: int, cout: int, stride: Stride) -> None:
        self.short = None
        if _strided(stride) or cin != cout:
            self.short = (f"Conv_{n}", f"BatchNorm_{n}")
            self.add_module(self.short[0], conv1x1(cin, cout, stride))
            self.add_module(self.short[1], bn_module(cout))

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        if self.short is None:
            return x
        conv, bn = (getattr(self, n) for n in self.short)
        return batch_norm(bn, promoted(conv, x))


class SEBasicBlock(_Shortcut):
    """conv3×3(stride) → BN → ReLU → conv3×3 → BN → SE(c/16, no bias),
    plus the shortcut, ReLU."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: Stride = 1):
        super().__init__()
        self.Conv_0 = conv3x3(inplanes, planes, stride)
        self.BatchNorm_0 = bn_module(planes)
        self.Conv_1 = conv3x3(planes, planes)
        self.BatchNorm_1 = bn_module(planes)
        self.SELayer_0 = SELayer(planes)
        self._shortcut(2, inplanes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(self.BatchNorm_0,
                                    promoted(self.Conv_0, x)))
        out = batch_norm(self.BatchNorm_1, promoted(self.Conv_1, out))
        out = self.SELayer_0(out)
        return torch.relu(out + self.residual(x))


class SEBasicBlockV2(_Shortcut):
    """Pre-activation: ReLU → conv3×3(stride) → BN → ReLU → conv3×3 → BN
    → SE(16, biased), plus the shortcut of the un-activated input, ReLU."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: Stride = 1):
        super().__init__()
        self.Conv_0 = conv3x3(inplanes, planes, stride)
        self.BatchNorm_0 = bn_module(planes)
        self.Conv_1 = conv3x3(planes, planes)
        self.BatchNorm_1 = bn_module(planes)
        self.SELayer_0 = SELayer(planes, internal=16, use_bias=True)
        self._shortcut(2, inplanes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = batch_norm(self.BatchNorm_0,
                         promoted(self.Conv_0, torch.relu(x)))
        out = batch_norm(self.BatchNorm_1,
                         promoted(self.Conv_1, torch.relu(out)))
        out = self.SELayer_0(out)
        return torch.relu(out + self.residual(x))


class SEBottleneck(_Shortcut):
    """1×1 → BN → ReLU → 3×3(stride) → BN → ReLU → 1×1 (×4) → BN → SE
    (16, biased, or c/16 bias-free with ``senet_se``), plus the shortcut,
    ReLU. ``senet_se`` is the SE-ResNet family's bottleneck
    (``models/senet.py``)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: Stride = 1,
                 senet_se: bool = False):
        super().__init__()
        out_ch = planes * 4
        self.Conv_0 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.BatchNorm_0 = bn_module(planes)
        self.Conv_1 = conv3x3(planes, planes, stride)
        self.BatchNorm_1 = bn_module(planes)
        self.Conv_2 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.BatchNorm_2 = bn_module(out_ch)
        self.SELayer_0 = (SELayer(out_ch) if senet_se else
                          SELayer(out_ch, internal=16, use_bias=True))
        self._shortcut(3, inplanes, out_ch, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(self.BatchNorm_0,
                                    promoted(self.Conv_0, x)))
        out = torch.relu(batch_norm(self.BatchNorm_1,
                                    promoted(self.Conv_1, out)))
        out = batch_norm(self.BatchNorm_2, promoted(self.Conv_2, out))
        out = self.SELayer_0(out)
        return torch.relu(out + self.residual(x))


_BLOCKS = {"basic": SEBasicBlock, "basicv2": SEBasicBlockV2,
           "bottleneck": SEBottleneck}


class ResNetSE(nn.Module):
    def __init__(self, n_mels: int = 80, nOut: int = 256,
                 block: str = "basic",
                 layers: Sequence[int] = (3, 4, 6, 3),
                 num_filters: Sequence[int] = (32, 64, 128, 256),
                 encoder_type: str = "ASP", att_dim: int = 128,
                 log_input: bool = True):
        super().__init__()
        if encoder_type not in ("ASP", "SAP"):
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        block_cls = _BLOCKS[block]
        self.encoder_type, self.log_input = encoder_type, log_input
        self.Conv_0 = conv3x3(1, num_filters[0], bias=True)
        self.BatchNorm_0 = bn_module(num_filters[0])
        self.blocks = []
        cin, freq = num_filters[0], n_mels
        for gi, (planes, n_blocks) in enumerate(zip(num_filters, layers)):
            for bi in range(n_blocks):
                stride = 2 if gi > 0 and bi == 0 else 1
                name = f"{block_cls.__name__}_{len(self.blocks)}"
                self.add_module(name, block_cls(cin, planes, stride))
                self.blocks.append(name)
                cin = planes * block_cls.expansion
                freq = -(-freq // stride)
        flat = cin * freq
        self.Conv_1 = nn.Conv1d(flat, att_dim, 1)
        self.BatchNorm_1 = bn_module(att_dim)
        self.Conv_2 = nn.Conv1d(att_dim, flat, 1)
        self.Dense_0 = nn.Linear(flat * (2 if encoder_type == "ASP" else 1),
                                 nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: features ``[B, frames, F]`` → ``[B, nOut]``."""
        x = log_cmn_instance_norm(x, self.log_input)
        h = promoted(self.Conv_0, x.transpose(1, 2)[:, None])  # [B,C,F,T]
        h = batch_norm(self.BatchNorm_0, torch.relu(h))
        for name in self.blocks:
            h = getattr(self, name)(h)
        B, C, F_, T = h.shape
        h = h.reshape(B, C * F_, T)
        attn = torch.relu(promoted(self.Conv_1, h))
        attn = promoted(self.Conv_2, batch_norm(self.BatchNorm_1, attn))
        w = torch.softmax(attn, dim=2)                       # over time
        mu = torch.sum(h * w, dim=2)
        if self.encoder_type == "SAP":
            pooled = mu
        else:
            sg = torch.sqrt(torch.clamp(torch.sum(h * h * w, dim=2) - mu * mu,
                                        min=1e-5))
            pooled = torch.cat([mu, sg], dim=-1)
        return promoted(self.Dense_0, pooled)


def _register(name: str, block: str, layers, filters, default_nout: int):
    @MODELS.register(name)
    def build(nOut: int = default_nout, **kwargs) -> ResNetSE:
        feature_type = kwargs.get("feature_type",
                                  kwargs.get("features", "melspectrogram"))
        return ResNetSE(n_mels=feature_dim(kwargs), nOut=nOut, block=block,
                        layers=tuple(layers), num_filters=tuple(filters),
                        encoder_type=kwargs.get("encoder_type", "ASP"),
                        log_input=(feature_type == "melspectrogram"))
    build.__name__ = f"build_{name.lower()}"
    build.__doc__ = f"{name}: {block} blocks {tuple(layers)}, filters " \
                    f"{tuple(filters)}, nOut {default_nout} by default."
    return build


_register("ResNetSE34", "basic", (3, 4, 6, 3), (32, 64, 128, 256), 256)
_register("ResNetSE34V2", "basicv2", (3, 4, 6, 3), (32, 64, 128, 256), 256)
_register("ResNetSE50", "bottleneck", (3, 4, 6, 3), (32, 64, 128, 256), 512)
_register("ResNetSE50V2", "bottleneck", (3, 4, 6, 3), (32, 64, 128, 256), 512)
_register("ResNetSE100m2", "bottleneck", (6, 16, 24, 3),
          (128, 128, 256, 256), 256)
_register("ResNetSE101", "bottleneck", (3, 4, 23, 3), (64, 128, 256, 512), 512)
_register("ResNetSE152", "bottleneck", (3, 8, 36, 3), (64, 128, 256, 512), 512)
