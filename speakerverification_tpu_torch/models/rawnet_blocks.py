"""RawNet building blocks (port of ``models/rawnet_blocks.py``),
channels-first: ``AFMS``, ``FRM``, ``Bottle2neckRaw`` (RawNet3),
``RawNetBasicBlock`` (RawNet2Custom), ``ResidualBlockFRM`` (RawNet2),
``max_pool1d`` and ``leaky_relu_03``.

``Bottle2neckRaw`` is not ECAPA's Res2Net: ReLU comes before BN, the
k-tap convs zero-pad ('SAME'), the groups accumulate
``sp = sp + chunks[i]`` and the LAST group passes through.

Children carry the flax auto-names, which number each kind of layer in
the order the JAX module calls them: a block's 1×1 shortcut conv, where
the width changes, is ``Conv_0`` in ``RawNetBasicBlock`` (called first)
and the last conv in ``ResidualBlockFRM`` (called last).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
)

__all__ = ["AFMS", "FRM", "Bottle2neckRaw", "RawNetBasicBlock",
           "ResidualBlockFRM", "max_pool1d", "leaky_relu_03"]


def max_pool1d(x: torch.Tensor, pool: int) -> torch.Tensor:
    """Non-overlapping temporal max pooling on ``[B, C, L]``."""
    return F.max_pool1d(x, pool, pool)


def leaky_relu_03(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.3)


class AFMS(nn.Module):
    """``x = (x + alpha) * sigmoid(fc(mean_t(x)))``."""

    def __init__(self, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(features, features)
        self.alpha = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.Dense_0(x.mean(dim=2)))
        return (x + self.alpha[:, None]) * y[:, :, None]


class FRM(nn.Module):
    """Filter-wise rescaling: ``y = sigmoid(fc(mean_t(x)))``, then
    ``x * y + y``."""

    def __init__(self, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.Dense_0(x.mean(dim=2)))[:, :, None]
        return x * y + y


class Bottle2neckRaw(nn.Module):
    """Res2-style bottleneck with ReLU→BN ordering, AFMS and an optional
    max pool. Children carry the flax auto-names, which count the
    residual conv first when the width changes."""

    def __init__(self, inplanes: int, planes: int, kernel_size: int = 3,
                 dilation: int = 1, scale: int = 4,
                 pool: Optional[int] = None):
        super().__init__()
        self.scale, self.pool = scale, pool
        width = planes // scale
        o = 0
        self.has_residual_conv = inplanes != planes
        if self.has_residual_conv:
            self.Conv_0 = nn.Conv1d(inplanes, planes, 1, bias=False)
            o = 1
        self.conv_names = [f"Conv_{o + i}" for i in range(scale + 1)]
        self.bn_names = [f"BatchNorm_{i}" for i in range(scale + 1)]
        pad = dilation * (kernel_size - 1) // 2       # 'SAME', odd kernel
        convs = ([nn.Conv1d(inplanes, width * scale, 1)]
                 + [nn.Conv1d(width, width, kernel_size, dilation=dilation,
                              padding=pad) for _ in range(scale - 1)]
                 + [nn.Conv1d(width * scale, planes, 1)])
        bns = ([bn_module(width * scale)]
               + [bn_module(width) for _ in range(scale - 1)]
               + [bn_module(planes)])
        for name, m in zip(self.conv_names, convs):
            self.add_module(name, m)
        for name, m in zip(self.bn_names, bns):
            self.add_module(name, m)
        self.AFMS_0 = AFMS(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, n) for n in self.conv_names]
        bns = [getattr(self, n) for n in self.bn_names]
        residual = self.Conv_0(x) if self.has_residual_conv else x

        out = batch_norm(bns[0], torch.relu(convs[0](x)))
        chunks = torch.chunk(out, self.scale, dim=1)
        outs = []
        sp = None
        for i in range(self.scale - 1):
            sp = chunks[i] if i == 0 else sp + chunks[i]
            sp = batch_norm(bns[1 + i], torch.relu(convs[1 + i](sp)))
            outs.append(sp)
        outs.append(chunks[-1])                      # last group passes through
        out = torch.cat(outs, dim=1)

        out = batch_norm(bns[-1], torch.relu(convs[-1](out)))
        out = out + residual
        if self.pool:
            out = max_pool1d(out, self.pool)
        return self.AFMS_0(out)


def _same_conv(cin: int, cout: int, bias: bool) -> nn.Conv1d:
    """A 3-tap conv zero-padded to the input's length ('SAME')."""
    return nn.Conv1d(cin, cout, 3, padding=1, bias=bias)


class RawNetBasicBlock(nn.Module):
    """Pre-activation residual block: BN → lrelu(0.3) → conv → BN →
    lrelu → conv, plus the shortcut (the input, or a 1×1 conv of the
    activated input where the width changes), an optional max pool of 3,
    then AFMS. The convs have no bias."""

    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.BatchNorm_0 = bn_module(inplanes)
        o = 0
        self.has_shortcut_conv = inplanes != planes
        if self.has_shortcut_conv:
            self.Conv_0 = nn.Conv1d(inplanes, planes, 1, bias=False)
            o = 1
        self.conv_names = (f"Conv_{o}", f"Conv_{o + 1}")
        self.add_module(self.conv_names[0], _same_conv(inplanes, planes, False))
        self.BatchNorm_1 = bn_module(planes)
        self.add_module(self.conv_names[1], _same_conv(planes, planes, False))
        self.AFMS_0 = AFMS(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, conv2 = (getattr(self, n) for n in self.conv_names)
        out = leaky_relu_03(batch_norm(self.BatchNorm_0, x))
        shortcut = self.Conv_0(out) if self.has_shortcut_conv else x
        out = batch_norm(self.BatchNorm_1, conv1(out))
        out = conv2(leaky_relu_03(out)) + shortcut
        if self.downsample:
            out = max_pool1d(out, 3)
        return self.AFMS_0(out)


class ResidualBlockFRM(nn.Module):
    """RawNet2's residual block: (BN → lrelu, unless ``first``) → conv →
    BN → lrelu → conv, plus the input (through a 1×1 conv where the width
    changes), max pool of 3, then FRM. The convs have a bias."""

    def __init__(self, in_filters: int, out_filters: int, first: bool = False):
        super().__init__()
        self.first = first
        if not first:
            self.BatchNorm_0 = bn_module(in_filters)
        self.mid_bn = "BatchNorm_0" if first else "BatchNorm_1"
        self.Conv_0 = _same_conv(in_filters, out_filters, True)
        self.add_module(self.mid_bn, bn_module(out_filters))
        self.Conv_1 = _same_conv(out_filters, out_filters, True)
        self.has_identity_conv = in_filters != out_filters
        if self.has_identity_conv:
            self.Conv_2 = nn.Conv1d(in_filters, out_filters, 1)
        self.FRM_0 = FRM(out_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x if self.first else leaky_relu_03(batch_norm(self.BatchNorm_0, x))
        out = leaky_relu_03(batch_norm(getattr(self, self.mid_bn),
                                       self.Conv_0(out)))
        identity = self.Conv_2(x) if self.has_identity_conv else x
        out = self.Conv_1(out) + identity
        return self.FRM_0(max_pool1d(out, 3))
