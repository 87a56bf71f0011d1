"""SE-ResNet image-style encoders (port of ``models/senet.py``).

torchvision's ResNet trunk with SE blocks: a 7×7/2 stem with explicit
(3, 3) padding, BN, ReLU, a 3×3/2 max pool padded by 1, four stages of
``SEBasicBlock``s or ``SENetBottleneck``s (64·2^stage planes; a 1×1 conv
+ BN shortcut wherever the stride or the width changes), the mean over
the image, a linear embedding. Both block kinds take the bias-free
``c/16`` excitation. The features go in as a mel image after log + CMN
(``log_input``, on for ``melspectrogram``) and a non-affine instance
norm: ``[B, frames, F] -> [B, nOut]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
    promoted,
)
from speakerverification_tpu_torch.models.resnetse import (
    SEBasicBlock,
    SEBottleneck,
    log_cmn_instance_norm,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["SEResNet", "prep"]


def prep(x: torch.Tensor, log_input: bool) -> torch.Tensor:
    """``[B, T, F]`` features → the ``[B, 1, F, T]`` mel image: log + CMN
    when ``log_input``, then each feature normalized over time (the JAX
    package's ``image_encoders._prep`` with its instance norm on)."""
    return log_cmn_instance_norm(x, log_input).transpose(1, 2)[:, None]


class SEResNet(nn.Module):
    def __init__(self, nOut: int = 512, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2),
                 log_input: bool = True):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown block {block!r}")
        self.log_input = log_input
        self.Conv_0 = nn.Conv2d(1, 64, 7, 2, padding=3, bias=False)
        self.BatchNorm_0 = bn_module(64)
        self.blocks = []
        cin = 64
        for stage, n in enumerate(layers):
            planes = 64 << stage
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                if block == "basic":
                    name, blk = (f"SEBasicBlock_{len(self.blocks)}",
                                 SEBasicBlock(cin, planes, stride))
                else:
                    name, blk = (f"SENetBottleneck_{len(self.blocks)}",
                                 SEBottleneck(cin, planes, stride,
                                              senet_se=True))
                self.add_module(name, blk)
                self.blocks.append(name)
                cin = planes * blk.expansion
        self.Dense_0 = nn.Linear(cin, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: features ``[B, frames, F]`` → ``[B, nOut]``."""
        h = promoted(self.Conv_0, prep(x, self.log_input))
        h = torch.relu(batch_norm(self.BatchNorm_0, h))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return promoted(self.Dense_0, h.mean(dim=(2, 3)))


def _register(name: str, block: str, layers):
    @MODELS.register(name)
    def build(nOut: int = 512, **kwargs) -> SEResNet:
        feature_type = kwargs.get("feature_type",
                                  kwargs.get("features", "melspectrogram"))
        return SEResNet(nOut=nOut, block=block, layers=tuple(layers),
                        log_input=(feature_type == "melspectrogram"))
    build.__name__ = f"build_{name}"
    return build


_register("se_resnet18", "basic", (2, 2, 2, 2))
_register("se_resnet34", "basic", (3, 4, 6, 3))
_register("se_resnet50", "bottleneck", (3, 4, 6, 3))
_register("se_resnet101", "bottleneck", (3, 4, 23, 3))
_register("se_resnet152", "bottleneck", (3, 8, 36, 3))
