"""RawNet3 building blocks (port of ``models/rawnet_blocks.py``):
``AFMS``, ``Bottle2neckRaw`` and ``max_pool1d``, channels-first.

``Bottle2neckRaw`` is not ECAPA's Res2Net: ReLU comes before BN, the
k-tap convs zero-pad ('SAME'), the groups accumulate
``sp = sp + chunks[i]`` and the LAST group passes through.
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

__all__ = ["AFMS", "Bottle2neckRaw", "max_pool1d"]


def max_pool1d(x: torch.Tensor, pool: int) -> torch.Tensor:
    """Non-overlapping temporal max pooling on ``[B, C, L]``."""
    return F.max_pool1d(x, pool, pool)


class AFMS(nn.Module):
    """``x = (x + alpha) * sigmoid(fc(mean_t(x)))``."""

    def __init__(self, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(features, features)
        self.alpha = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.Dense_0(x.mean(dim=2)))
        return (x + self.alpha[:, None]) * y[:, :, None]


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
