"""Mel-image encoders (port of ``models/image_encoders.py``): EfficientNet
v1 (b0–b7) and v2 (effnetv2-s), RepVGG (D2se) with its deploy fold,
SCNet-50 and DPN.

Each takes features ``[B, frames, F]``, made a mel image ``[B, 1, F, T]``
after log + CMN (``log_input``, on for ``melspectrogram``) and a
non-affine instance norm (not in RepVGG), and returns ``[B, nOut]``.
Inside, the image is channels-first ``[B, C, F, T]`` (the JAX modules'
is ``[B, F, T, C]``); children carry the flax auto-names, numbered per
kind in the order the JAX module creates them.

Padding: flax's ``'SAME'`` at stride 2 pads 0 before and 1 after an even
size (:func:`same_pad`), which torch's symmetric ``padding`` cannot
express, so EfficientNet v1 (its stem and its strided depthwise convs)
pads explicitly; the other families pad as torch does. SCNet upsamples
with half-pixel centres (``nearest-exact``), as ``jax.image.resize``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import (
    Dropout,
    batch_norm,
    bn_module,
    promoted,
)
from speakerverification_tpu_torch.models.resnetse import (
    log_cmn_instance_norm,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["EfficientNet", "EfficientNetV2", "RepVGG", "SCNet", "DPN",
           "MBConv", "MBConvV2", "FusedMBConv", "RepVGGBlock",
           "SCBottleneck", "DualPathBlock", "prep", "same_pad",
           "make_divisible", "repvgg_reparameterize"]


def prep(x: torch.Tensor, log_input: bool,
         instance_norm: bool = True) -> torch.Tensor:
    """``[B, T, F]`` features → the ``[B, 1, F, T]`` mel image: log + CMN
    when ``log_input``, then (``instance_norm``) each feature normalized
    over time. RepVGG takes no instance norm."""
    if instance_norm:
        x = log_cmn_instance_norm(x, log_input)
    elif log_input:
        x = torch.log(torch.clamp(x, min=0.0) + 1e-6)
        x = x - x.mean(dim=1, keepdim=True)
    return x.transpose(1, 2)[:, None]


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` ``[B, C, H, W]`` padded as flax's ``padding='SAME'`` pads it:
    each axis to ``ceil(n / stride)`` outputs, the odd pixel after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad's order: W, then H
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _bn(features: int, eps: float = 1e-5) -> nn.BatchNorm1d:
    """A BatchNorm's container (flax momentum 0.9); ``eps`` 1e-3 in
    EfficientNet v1."""
    return nn.BatchNorm1d(features, eps=eps, momentum=0.1)


def _se(h: torch.Tensor, d0: nn.Linear, d1: nn.Linear, act) -> torch.Tensor:
    """Squeeze-excitation over ``[B, C, H, W]``: mean → ``act(d0)`` →
    ``sigmoid(d1)`` → a per-channel scale."""
    s = act(promoted(d0, h.mean(dim=(2, 3))))
    return h * torch.sigmoid(promoted(d1, s))[:, :, None, None]


class _Named(nn.Module):
    """A module whose children take flax's auto-names: ``Conv_0``,
    ``BatchNorm_0``, ``Conv_1``, ..., numbered per kind in creation
    order."""

    def __init__(self):
        super().__init__()
        self._counts: dict[str, int] = {}

    def _add(self, kind: str, module: nn.Module) -> str:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        name = f"{kind}_{n}"
        self.add_module(name, module)
        return name

    def _conv_bn(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding=0, groups: int = 1, dilation: int = 1,
                 eps: float = 1e-5) -> Tuple[str, str]:
        """A bias-free conv and the BatchNorm after it; their names."""
        return (self._add("Conv", nn.Conv2d(cin, cout, kernel, stride,
                                            padding=padding, groups=groups,
                                            dilation=dilation, bias=False)),
                self._add("BatchNorm", _bn(cout, eps)))

    def _cbn(self, names: Tuple[str, str], x: torch.Tensor) -> torch.Tensor:
        return batch_norm(getattr(self, names[1]),
                          promoted(getattr(self, names[0]), x))


# ---------------------------------------------------------------------------
# EfficientNet v1
# ---------------------------------------------------------------------------

class MBConv(_Named):
    """Inverted residual: 1×1 expand (when ``expand`` > 1) → k×k
    depthwise ('SAME') → SE squeezed from the block's input width
    (``int(in·se_ratio)``) → 1×1 project, swish activations, a plain
    residual where the shape holds."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, se_ratio: float = 0.25, bn_eps: float = 1e-5):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        hidden = in_ch * expand
        self.expand_names = (self._conv_bn(in_ch, hidden, 1, eps=bn_eps)
                             if expand != 1 else None)
        self.dw_names = self._conv_bn(hidden, hidden, kernel, stride,
                                      groups=hidden, eps=bn_eps)
        se_ch = max(1, int(in_ch * se_ratio))
        self.Dense_0 = nn.Linear(hidden, se_ch)
        self.Dense_1 = nn.Linear(se_ch, hidden)
        self.project_names = self._conv_bn(hidden, out_ch, 1, eps=bn_eps)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_names is not None:
            h = F.silu(self._cbn(self.expand_names, h))
        h = F.silu(self._cbn(self.dw_names,
                             same_pad(h, self.kernel, self.stride)))
        h = self._cbn(self.project_names,
                      _se(h, self.Dense_0, self.Dense_1, F.silu))
        return h + x if self.residual else h


class EfficientNet(_Named):
    """b4 by default: the stem 3×3/2 ('SAME'), seven stages of MBConvs
    scaled by ``width_coeff`` and ``depth_coeff``, a 1×1 head conv, the
    mean over the image, dropout, then the head Dense. With ``'ASP'``
    the Dense reads ``[mean ∥ √1e-5]``: the reference's attentive
    pooling after the global pool sees one time step, whose std is its
    clamp. BatchNorm eps 1e-3 throughout. Dropout draws from the
    ``rng`` ``forward`` is given."""
    draws_dropout = True

    def __init__(self, nOut: int = 512, width_coeff: float = 1.4,
                 depth_coeff: float = 1.8, dropout_rate: float = 0.4,
                 aggregate: str = "ASP", log_input: bool = True):
        super().__init__()
        self.width_coeff, self.depth_coeff = width_coeff, depth_coeff
        self.aggregate, self.log_input = aggregate, log_input
        stem = self._ch(32)
        self.stem_names = self._conv_bn(1, stem, 3, 2, eps=1e-3)
        self.blocks = []
        cin = stem
        specs = [(16, 1, 3, 1, 1), (24, 6, 3, 2, 2), (40, 6, 5, 2, 2),
                 (80, 6, 3, 2, 3), (112, 6, 5, 1, 3), (192, 6, 5, 2, 4),
                 (320, 6, 3, 1, 1)]
        for out, expand, k, s, rep in specs:
            for i in range(self._rep(rep)):
                self.blocks.append(self._add("MBConv", MBConv(
                    cin, self._ch(out), expand, k, s if i == 0 else 1,
                    bn_eps=1e-3)))
                cin = self._ch(out)
        head = self._ch(1280)
        self.head_names = self._conv_bn(cin, head, 1, eps=1e-3)
        self.dropout = Dropout(dropout_rate)
        self.Dense_0 = nn.Linear(head if aggregate == "flatten" else 2 * head,
                                 nOut)

    def _ch(self, x: int) -> int:
        x *= self.width_coeff
        new = max(8, int(x + 4) // 8 * 8)
        return new + 8 if new < 0.9 * x else new

    def _rep(self, x: int) -> int:
        return int(math.ceil(x * self.depth_coeff))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: features ``[B, frames, F]`` → ``[B, nOut]``."""
        h = F.silu(self._cbn(self.stem_names,
                             same_pad(prep(x, self.log_input), 3, 2)))
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = F.silu(self._cbn(self.head_names, h))
        pooled = self.dropout(h.mean(dim=(2, 3)), rng)
        if self.aggregate == "flatten":
            return promoted(self.Dense_0, pooled)
        sg = torch.full_like(pooled, 1e-5).sqrt()
        return promoted(self.Dense_0, torch.cat([pooled, sg], dim=-1))


# ---------------------------------------------------------------------------
# EfficientNet v2 (effnetv2-s)
# ---------------------------------------------------------------------------

def make_divisible(v: float, divisor: int = 8) -> int:
    """The reference's channel rounding."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MBConvV2(_Named):
    """v2 MBConv: 1×1 to ``round(in·expand)`` → 3×3 depthwise (torch's
    padding 1) → SE squeezed to ``make_divisible(in // 4)`` → 1×1
    project; SiLU."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int):
        super().__init__()
        hidden = round(in_ch * expand)
        self.expand_names = self._conv_bn(in_ch, hidden, 1)
        self.dw_names = self._conv_bn(hidden, hidden, 3, stride, padding=1,
                                      groups=hidden)
        se = make_divisible(in_ch // 4, 8)
        self.Dense_0 = nn.Linear(hidden, se)
        self.Dense_1 = nn.Linear(se, hidden)
        self.project_names = self._conv_bn(hidden, out_ch, 1)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self._cbn(self.expand_names, x))
        h = F.silu(self._cbn(self.dw_names, h))
        h = self._cbn(self.project_names,
                      _se(h, self.Dense_0, self.Dense_1, F.silu))
        return h + x if self.residual else h


class FusedMBConv(_Named):
    """v2 fused block: 3×3 (padding 1) to ``round(in·expand)``, then a
    1×1 projection (kept at ``expand`` 1, as the reference keeps it)."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int):
        super().__init__()
        hidden = round(in_ch * expand)
        self.fused_names = self._conv_bn(in_ch, hidden, 3, stride, padding=1)
        self.project_names = self._conv_bn(hidden, out_ch, 1)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._cbn(self.project_names,
                      F.silu(self._cbn(self.fused_names, x)))
        return h + x if self.residual else h


class EfficientNetV2(_Named):
    """effnetv2-s: the stem 3×3/2 (padding 1) to ``make_divisible(24·w)``,
    fused blocks (``use_se`` 0) then MBConvV2s, a 1×1 head to 1,792
    (scaled only when ``width_mult`` > 1), the mean over the image, a
    Dense."""

    def __init__(self, nOut: int = 512, log_input: bool = True,
                 width_mult: float = 1.0,
                 cfgs: Sequence[Tuple[int, int, int, int, int]] = (
                     (1, 24, 2, 1, 0), (4, 48, 4, 2, 0), (4, 64, 4, 2, 0),
                     (4, 128, 6, 2, 1), (6, 160, 9, 1, 1),
                     (6, 256, 15, 2, 1))):
        super().__init__()
        self.log_input = log_input
        cin = make_divisible(24 * width_mult, 8)
        self.stem_names = self._conv_bn(1, cin, 3, 2, padding=1)
        self.blocks = []
        for t, c, n, s, use_se in cfgs:
            out = make_divisible(c * width_mult, 8)
            for i in range(n):
                stride = s if i == 0 else 1
                kind = MBConvV2 if use_se else FusedMBConv
                self.blocks.append(self._add(kind.__name__,
                                             kind(cin, out, t, stride)))
                cin = out
        head = (make_divisible(1792 * width_mult, 8) if width_mult > 1.0
                else 1792)
        self.head_names = self._conv_bn(cin, head, 1)
        self.Dense_0 = nn.Linear(head, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self._cbn(self.stem_names, prep(x, self.log_input)))
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = F.silu(self._cbn(self.head_names, h))
        return promoted(self.Dense_0, h.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# RepVGG
# ---------------------------------------------------------------------------

class RepVGGBlock(nn.Module):
    """Train layout: 3×3 (padding 1) + BN, 1×1 + BN, and a BN of the input
    where the shape holds, summed; deploy layout: one biased 3×3
    (``rbr_reparam``). Then SE (``out // 8``, biased, ReLU) and ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 use_se: bool = False, deploy: bool = False):
        super().__init__()
        self.deploy, self.use_se = deploy, use_se
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_ch, out_ch, 3, stride, padding=1)
        else:
            self.rbr_dense = nn.Conv2d(in_ch, out_ch, 3, stride, padding=1,
                                       bias=False)
            self.BatchNorm_0 = bn_module(out_ch)
            self.rbr_1x1 = nn.Conv2d(in_ch, out_ch, 1, stride, bias=False)
            self.BatchNorm_1 = bn_module(out_ch)
            if in_ch == out_ch and stride == 1:
                self.BatchNorm_2 = bn_module(in_ch)
        if use_se:
            self.Dense_0 = nn.Linear(out_ch, max(out_ch // 8, 1))
            self.Dense_1 = nn.Linear(max(out_ch // 8, 1), out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            h = promoted(self.rbr_reparam, x)
        else:
            h = (batch_norm(self.BatchNorm_0, promoted(self.rbr_dense, x))
                 + batch_norm(self.BatchNorm_1, promoted(self.rbr_1x1, x)))
            if hasattr(self, "BatchNorm_2"):
                h = h + batch_norm(self.BatchNorm_2, x)
        if self.use_se:
            h = _se(h, self.Dense_0, self.Dense_1, torch.relu)
        return torch.relu(h)


class RepVGG(nn.Module):
    """RepVGG-D2se: a stride-2 stem block, four stages of
    ``num_blocks`` blocks at ``int(64·2^stage·width)`` channels (each
    opening with stride 2), the mean over the image, a Dense. No instance
    norm of the input, as in the reference."""

    def __init__(self, nOut: int = 256,
                 num_blocks: Sequence[int] = (8, 14, 24, 1),
                 width: Sequence[float] = (2.5, 2.5, 2.5, 5.0),
                 use_se: bool = True, deploy: bool = False,
                 log_input: bool = True):
        super().__init__()
        self.log_input = log_input
        cin = min(64, int(64 * width[0]))
        self.RepVGGBlock_0 = RepVGGBlock(1, cin, 2, use_se, deploy)
        self.n_blocks = 1
        for stage, (n, w) in enumerate(zip(num_blocks, width)):
            out_ch = int((64 << stage) * w)
            for i in range(n):
                self.add_module(f"RepVGGBlock_{self.n_blocks}", RepVGGBlock(
                    cin, out_ch, 2 if i == 0 else 1, use_se, deploy))
                self.n_blocks += 1
                cin = out_ch
        self.Dense_0 = nn.Linear(cin, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = prep(x, self.log_input, instance_norm=False)
        for i in range(self.n_blocks):
            h = getattr(self, f"RepVGGBlock_{i}")(h)
        return promoted(self.Dense_0, h.mean(dim=(2, 3)))


@torch.no_grad()
def repvgg_reparameterize(state: Mapping[str, torch.Tensor],
                          eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """Fold a train-layout RepVGG ``state_dict`` into the deploy layout's
    (``deploy=True``): per block, each conv's BN folded into
    ``(weight·t, β − μ·t)`` with ``t = γ/√(σ² + eps)``, the 1×1 padded to
    3×3, the identity BN as a 3×3 identity kernel, all summed into
    ``rbr_reparam``. SE and head weights are copied. Raises
    ``ValueError`` on a state without BatchNorm statistics."""
    if not any(k.endswith("running_mean") for k in state):
        raise ValueError("repvgg_reparameterize needs the BatchNorm "
                         "statistics (running_mean/var) to fold")

    def fuse(kernel, bn):
        t = state[f"{bn}.weight"] / torch.sqrt(state[f"{bn}.running_var"]
                                               + eps)
        return (kernel * t[:, None, None, None],
                state[f"{bn}.bias"] - state[f"{bn}.running_mean"] * t)

    out: dict[str, torch.Tensor] = {}
    blocks = sorted({k.split(".")[0] for k in state
                     if k.startswith("RepVGGBlock_")})
    for k, v in state.items():
        if not k.startswith("RepVGGBlock_"):
            out[k] = v.clone()
        elif ".Dense_" in k:                      # SE denses pass through
            out[k] = v.clone()
    for blk in blocks:
        k3, b3 = fuse(state[f"{blk}.rbr_dense.weight"], f"{blk}.BatchNorm_0")
        k1, b1 = fuse(state[f"{blk}.rbr_1x1.weight"], f"{blk}.BatchNorm_1")
        kernel, bias = k3 + F.pad(k1, (1, 1, 1, 1)), b3 + b1
        if f"{blk}.BatchNorm_2.weight" in state:           # identity branch
            kid = torch.zeros_like(k3)
            idx = torch.arange(k3.shape[1])
            kid[idx, idx, 1, 1] = 1.0
            kf, bf = fuse(kid, f"{blk}.BatchNorm_2")
            kernel, bias = kernel + kf, bias + bf
        out[f"{blk}.rbr_reparam.weight"] = kernel
        out[f"{blk}.rbr_reparam.bias"] = bias
    return out


# ---------------------------------------------------------------------------
# SCNet
# ---------------------------------------------------------------------------

class SCBottleneck(_Named):
    """Self-calibrated bottleneck: two halves of ``planes // 2`` — a 1×1
    then a k1 3×3 (stride, dilation ``d``, padding ``d``); a 1×1 then the
    self-calibration: ``AvgPool(r)`` → k2 → BN → nearest upsample
    (half-pixel centres), gate ``sigmoid(b + k2)`` on ``k3(b)``, then k4
    (stride) — concatenated, a 1×1 to ``planes·4`` + BN, the shortcut (a
    1×1 + BN on a stride or width change), ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, pooling_r: int = 4):
        super().__init__()
        half, d = planes // 2, dilation
        self.pooling_r = pooling_r
        self.a1 = self._conv_bn(in_ch, half, 1)
        self.a2 = self._conv_bn(half, half, 3, stride, d, dilation=d)
        self.b1 = self._conv_bn(in_ch, half, 1)
        self.k2 = self._conv_bn(half, half, 3, 1, d, dilation=d)
        self.k3 = self._conv_bn(half, half, 3, 1, d, dilation=d)
        self.k4 = self._conv_bn(half, half, 3, stride, d, dilation=d)
        self.out_names = self._conv_bn(2 * half, planes * 4, 1)
        self.short = (self._conv_bn(in_ch, planes * 4, 1, stride)
                      if stride != 1 or in_ch != planes * 4 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.relu(self._cbn(self.a1, x))
        a = torch.relu(self._cbn(self.a2, a))
        b = torch.relu(self._cbn(self.b1, x))
        # AvgPool2d(r, r), the window clamped to the map
        r = max(1, min(self.pooling_r, b.shape[2], b.shape[3]))
        k2 = self._cbn(self.k2, F.avg_pool2d(b, r, r))
        k2 = F.interpolate(k2, size=b.shape[2:], mode="nearest-exact")
        b = self._cbn(self.k3, b) * torch.sigmoid(b + k2)
        b = torch.relu(self._cbn(self.k4, b))
        out = self._cbn(self.out_names, torch.cat([a, b], dim=1))
        residual = x if self.short is None else self._cbn(self.short, x)
        return torch.relu(out + residual)


class SCNet(_Named):
    """SCNet-50 (dilated): the 7×7/2 stem (padding 3), BN, ReLU, a 3×3/2
    max pool (padding 1), four stages of ``layers`` SCBottlenecks at
    64·2^stage planes; with ``dilated`` the last two keep stride 1 and
    dilate (first block 1 then 2; 2 then 4). The mean, a Dense."""

    def __init__(self, nOut: int = 256, layers: Sequence[int] = (3, 4, 6, 3),
                 log_input: bool = True, dilated: bool = True):
        super().__init__()
        self.log_input = log_input
        self.stem_names = self._conv_bn(1, 64, 7, 2, 3)
        self.blocks = []
        cin = 64
        for stage, n in enumerate(layers):
            planes = 64 << stage
            for i in range(n):
                if dilated and stage >= 2:
                    stride = 1
                    base = 2 if stage == 2 else 4
                    dil = base // 2 if i == 0 else base
                else:
                    stride = 2 if stage > 0 and i == 0 else 1
                    dil = 1
                self.blocks.append(self._add("SCBottleneck", SCBottleneck(
                    cin, planes, stride, dil)))
                cin = planes * 4
        self.Dense_0 = nn.Linear(cin, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self._cbn(self.stem_names, prep(x, self.log_input)))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return promoted(self.Dense_0, h.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# DPN
# ---------------------------------------------------------------------------

class DualPathBlock(_Named):
    """Pre-activation dual-path block: every conv is BN → ReLU → conv (no
    BN after). ``proj``/``down`` blocks run one more pre-activated 1×1
    (stride 2 for ``down``) and slice it into the residual and dense
    shortcuts; the block's 1×1 → grouped 3×3 → 1×1 output adds its first
    ``num_1x1_c`` channels to the residual path and appends the rest to
    the dense path. Takes and returns ``(res, dense)``; the first block
    takes the stem's map."""

    def __init__(self, in_ch: int, num_1x1_a: int, num_3x3_b: int,
                 num_1x1_c: int, inc: int, groups: int = 32,
                 block_type: str = "normal"):
        super().__init__()
        self.num_1x1_c = num_1x1_c
        stride = 2 if block_type == "down" else 1
        self.proj = (self._bn_conv(in_ch, num_1x1_c + 2 * inc, 1, stride)
                     if block_type in ("proj", "down") else None)
        self.c1 = self._bn_conv(in_ch, num_1x1_a, 1)
        self.c2 = self._bn_conv(num_1x1_a, num_3x3_b, 3, stride, groups)
        self.c3 = self._bn_conv(num_3x3_b, num_1x1_c + inc, 1)

    def _bn_conv(self, cin, cout, k, stride=1, groups=1):
        return (self._add("BatchNorm", bn_module(cin)),
                self._add("Conv", nn.Conv2d(cin, cout, k, stride, k // 2,
                                            groups=groups, bias=False)))

    def _run(self, names, h):
        return promoted(getattr(self, names[1]),
                        torch.relu(batch_norm(getattr(self, names[0]), h)))

    def forward(self, data):
        if isinstance(data, (tuple, list)):
            res, dense = data
            x = torch.cat([res, dense], dim=1)
        else:
            res = dense = None
            x = data
        c = self.num_1x1_c
        if self.proj is not None:
            p = self._run(self.proj, x)
            res, dense = p[:, :c], p[:, c:]
        h = self._run(self.c3, self._run(self.c2, self._run(self.c1, x)))
        return res + h[:, :c], torch.cat([dense, h[:, c:]], dim=1)


class DPN(_Named):
    """Dual Path Network: the 7×7/2 stem (padding 3), BN, ReLU, a 3×3/2
    max pool (padding 1); stage s at ``bw = 256·2^s``, ``R = k_r·bw/256``,
    opening with a ``proj`` (stage 0) or ``down`` block; the residual and
    dense paths concatenated, the mean, a Dense."""

    def __init__(self, nOut: int = 512, k_r: int = 96, groups: int = 32,
                 k_sec: Sequence[int] = (3, 4, 8, 3),
                 inc_sec: Sequence[int] = (16, 32, 24, 128),
                 num_init_features: int = 64, log_input: bool = True):
        super().__init__()
        self.log_input = log_input
        self.stem_names = self._conv_bn(1, num_init_features, 7, 2, 3)
        self.blocks = []
        res_ch, dense_ch = num_init_features, 0
        for stage, (n, inc) in enumerate(zip(k_sec, inc_sec)):
            bw = 256 << stage
            r = int(k_r * bw / 256)
            for i in range(n):
                btype = ("proj" if stage == 0 else "down") if i == 0 \
                    else "normal"
                self.blocks.append(self._add("DualPathBlock", DualPathBlock(
                    res_ch + dense_ch, r, r, bw, inc, groups, btype)))
                if btype != "normal":
                    dense_ch = 2 * inc
                res_ch, dense_ch = bw, dense_ch + inc
        self.Dense_0 = nn.Linear(res_ch + dense_ch, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self._cbn(self.stem_names, prep(x, self.log_input)))
        data = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.blocks:
            data = getattr(self, name)(data)
        feats = torch.cat(data, dim=1)
        return promoted(self.Dense_0, feats.mean(dim=(2, 3)))


def _log_input(kwargs) -> bool:
    return kwargs.get("feature_type", kwargs.get(
        "features", "melspectrogram")) == "melspectrogram"


@MODELS.register("EfficientNet")
def build_efficientnet(nOut: int = 512, version: str = "b4",
                       aggregate: str = "ASP", **kwargs) -> EfficientNet:
    """EfficientNet ``version`` (b0–b7: width, depth, dropout)."""
    params = {"b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2),
              "b2": (1.1, 1.2, 0.3), "b3": (1.2, 1.4, 0.3),
              "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
              "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5)}
    w, d, p = params[version]
    return EfficientNet(nOut=nOut, width_coeff=w, depth_coeff=d,
                        dropout_rate=p, aggregate=aggregate,
                        log_input=_log_input(kwargs))


@MODELS.register("EfficientNetv2")
def build_efficientnetv2(nOut: int = 512, **kwargs) -> EfficientNetV2:
    """effnetv2-s by default; ``cfgs`` and ``width_mult`` override."""
    opts = {k: kwargs[k] for k in ("cfgs", "width_mult") if k in kwargs}
    if "cfgs" in opts:
        opts["cfgs"] = tuple(tuple(c) for c in opts["cfgs"])
    return EfficientNetV2(nOut=nOut, log_input=_log_input(kwargs), **opts)


@MODELS.register("RepVGG")
def build_repvgg(nOut: int = 256, deploy: bool = False, **kwargs) -> RepVGG:
    """RepVGG-D2se (``deploy``: the folded layout)."""
    return RepVGG(nOut=nOut, deploy=deploy, log_input=_log_input(kwargs))


@MODELS.register("SCnet")
def build_scnet(nOut: int = 256, **kwargs) -> SCNet:
    """SCNet-50, dilated."""
    return SCNet(nOut=nOut, log_input=_log_input(kwargs))


@MODELS.register("DPN")
def build_dpn(nOut: int = 512, **kwargs) -> DPN:
    """DPN at dpn92's widths and (3, 4, 8, 3) blocks; ``k_sec``,
    ``inc_sec``, ``k_r``, ``groups``, ``num_init_features`` override."""
    opts = {k: kwargs[k] for k in
            ("k_r", "groups", "num_init_features") if k in kwargs}
    for k in ("k_sec", "inc_sec"):
        if k in kwargs:
            opts[k] = tuple(kwargs[k])
    return DPN(nOut=nOut, log_input=_log_input(kwargs), **opts)
