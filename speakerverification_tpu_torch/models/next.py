"""RawNeXt and ResNeXt raw-waveform encoders (port of ``models/next.py``).

Channels-first ``[B, C, L]`` inside. Each wave is wrapped per example to
3¹⁰ = 59,049 samples; a strided conv and two plain conv levels, then
four levels of elastic ResNeXt bottlenecks (RawNeXt: in DLA trees,
ResNeXt: plain stacks), each followed by a max pool of 3; attentive
statistics pooling, BN, a Dense and BN; training codes are rescaled to
norm 9. Children carry the flax auto-names (``Tree_0``, ``Root_0``,
``ElasticBottleneck_1``, ``ConvTranspose_0``, ...).

Two things differ from torch's own layers and are reproduced here:

* flax's ``nn.ConvTranspose`` does not flip its kernel: with k 3,
  stride 3, it computes ``y[3i+j] = x[i]·K[2−j]``. The port's
  ``ConvTranspose1d`` holds the flipped kernel (the weight bridge flips
  the tap axis), so that torch's ``y[3i+j] = x[i]·W[j]`` agrees.
* ``GateModule`` pools the concatenated branches to ``[B, n·C]`` and
  reads it as ``[B, C, n]`` (slot j of channel i is concatenated channel
  n·i + j, an interleaved view), while the softmax weights multiply each
  branch whole.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
    promoted,
)
from speakerverification_tpu_torch.models.rawnet_blocks import max_pool1d
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["RawNeXt", "ResNeXt", "GateModule", "ElasticBottleneck", "Root",
           "Tree", "FIXED_SAMPLES", "wrap_to_fixed"]

FIXED_SAMPLES = 59049          # 3^10


def wrap_to_fixed(x: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` waves, each tiled along time and cut to 59,049 samples."""
    reps = FIXED_SAMPLES // x.shape[1] + 1
    return x.repeat(1, reps)[:, :FIXED_SAMPLES]


class GateModule(nn.Module):
    """Softmax gate over ``nb_input`` branch outputs ``[B, C, L]``: their
    time means concatenated ``[B, n·C]``, read as ``[B, C, n]`` (the
    reference's interleaved view), 1×1 conv → ReLU → BN → 1×1 conv, a
    softmax over the n slots; slot i's weights scale branch i."""

    def __init__(self, channels: int, bottleneck: int, nb_input: int):
        super().__init__()
        self.channels = channels
        self.Conv_0 = nn.Conv1d(channels, bottleneck, 1)
        self.BatchNorm_0 = bn_module(bottleneck)
        self.Conv_1 = nn.Conv1d(bottleneck, channels, 1)

    def forward(self, branches) -> torch.Tensor:
        n = len(branches)
        pooled = torch.cat([b.mean(dim=2) for b in branches], dim=1)
        gate_in = pooled.reshape(pooled.shape[0], self.channels, n)
        h = batch_norm(self.BatchNorm_0,
                       torch.relu(promoted(self.Conv_0, gate_in)))
        w = torch.softmax(promoted(self.Conv_1, h), dim=2)    # [B, C, n]
        return sum(w[:, :, i, None] * branches[i] for i in range(n))


class ElasticBottleneck(nn.Module):
    """ResNeXt bottleneck with the dynamic scaling policy: the branch
    (1×1 → 3-tap in 32 groups, 16 with ``dsp``, 'SAME' → 1×1 to
    ``planes``; the JAX module's dilation is never set) at the original
    resolution, and with ``dsp`` one at a third (avg pool 3 → branch →
    transposed conv ×3) and, with ``up_path``, one at three times
    (transposed conv ×3 → branch → avg pool 3), aggregated by the gate
    (``gate``) or summed; the shared BN, the residual (a 1×1 where the
    width changes), ReLU."""

    def __init__(self, inplanes: int, planes: int, dsp: bool = True,
                 up_path: bool = True, gate: bool = True):
        super().__init__()
        self.dsp, self.up_path = dsp, up_path
        card, width = 32, planes
        if dsp:
            card //= 2
            width //= 2
            card_split = card // 2 if up_path else card
            width_split = width // 2 if up_path else width
        self.n_conv = self.n_bn = 0
        self.residual = (self._conv(inplanes, planes, 1)
                         if inplanes != planes else None)
        self.main = self._branch(inplanes, width, card, planes)
        n_branches = 1
        if dsp:
            self.down = self._branch(inplanes, width_split, card_split,
                                     planes)
            self.ConvTranspose_0 = nn.ConvTranspose1d(planes, planes, 3, 3)
            n_branches += 1
            if up_path:
                self.ConvTranspose_1 = nn.ConvTranspose1d(inplanes,
                                                          inplanes, 3, 3)
                self.up = self._branch(inplanes, width_split, card_split,
                                       planes)
                n_branches += 1
        self.gated = dsp and gate
        if self.gated:
            self.GateModule_0 = GateModule(
                planes, max(planes // n_branches, 1), n_branches)
        self.bn_out = self._bn(planes)

    def _conv(self, cin, cout, k, groups=1) -> str:
        """A bias-free conv, zero-padded to the input's length."""
        name = f"Conv_{self.n_conv}"
        self.n_conv += 1
        self.add_module(name, nn.Conv1d(cin, cout, k, padding=(k - 1) // 2,
                                        groups=groups, bias=False))
        return name

    def _bn(self, features) -> str:
        name = f"BatchNorm_{self.n_bn}"
        self.n_bn += 1
        self.add_module(name, bn_module(features))
        return name

    def _branch(self, cin, width, card, planes) -> tuple:
        return (self._conv(cin, width, 1), self._bn(width),
                self._conv(width, width, 3, groups=card), self._bn(width),
                self._conv(width, planes, 1))

    def _run(self, names, x):
        c1, b1, c2, b2, c3 = (getattr(self, n) for n in names)
        h = torch.relu(batch_norm(b1, promoted(c1, x)))
        h = torch.relu(batch_norm(b2, promoted(c2, h)))
        return promoted(c3, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.residual is None else promoted(
            getattr(self, self.residual), x)
        out = self._run(self.main, x)
        L = out.shape[2]
        branches = [out]
        if self.dsp:
            out_d = self._run(self.down, F.avg_pool1d(x, 3, 3))
            branches.append(promoted(self.ConvTranspose_0, out_d)[:, :, :L])
            if self.up_path:
                out_u = self._run(self.up, promoted(self.ConvTranspose_1, x))
                branches.append(F.avg_pool1d(out_u, 3, 3)[:, :, :L])
        out = self.GateModule_0(branches) if self.gated else sum(branches)
        return torch.relu(batch_norm(getattr(self, self.bn_out), out)
                          + residual)


class Root(nn.Module):
    """DLA root: a bias-free 1×1 over the concatenated children, BN, ReLU
    (the trees never set the JAX module's kernel size or residual)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_ch, features, 1, bias=False)
        self.BatchNorm_0 = bn_module(features)

    def forward(self, children) -> torch.Tensor:
        return torch.relu(batch_norm(
            self.BatchNorm_0,
            promoted(self.Conv_0, torch.cat(children, dim=1))))


class Tree(nn.Module):
    """DLA tree aggregation. ``levels`` 1: two bottlenecks and a root over
    ``[x2, x1, *children]``; deeper: ``Tree_0`` on x, its output joins the
    children handed to ``Tree_1``. ``level_root`` adds the tree's input to
    the children. ``children_ch`` are the widths of the children the tree
    is handed (the root's input width depends on them)."""

    def __init__(self, in_ch: int, levels: int, planes: int,
                 level_root: bool = False, dsp: bool = True,
                 up_path: bool = True, gate: bool = True,
                 children_ch: Optional[list] = None):
        super().__init__()
        self.levels, self.level_root = levels, level_root
        children_ch = [] if children_ch is None else children_ch
        if level_root:
            children_ch.append(in_ch)
        if levels == 1:
            self.ElasticBottleneck_0 = ElasticBottleneck(in_ch, planes, dsp,
                                                         up_path, gate)
            self.ElasticBottleneck_1 = ElasticBottleneck(planes, planes, dsp,
                                                         up_path, gate)
            self.Root_0 = Root(planes * 2 + sum(children_ch), planes)
        else:
            self.Tree_0 = Tree(in_ch, levels - 1, planes, False, dsp,
                               up_path, gate)
            children_ch.append(planes)
            self.Tree_1 = Tree(planes, levels - 1, planes, False, dsp,
                               up_path, gate, children_ch)

    def forward(self, x: torch.Tensor,
                children: Optional[list] = None) -> torch.Tensor:
        children = [] if children is None else children
        if self.level_root:
            children.append(x)
        if self.levels == 1:
            x1 = self.ElasticBottleneck_0(x)
            x2 = self.ElasticBottleneck_1(x1)
            return self.Root_0([x2, x1, *children])
        x1 = self.Tree_0(x)
        children.append(x1)
        return self.Tree_1(x1, children)


class _NeXtBase(nn.Module):
    use_tree = True

    def __init__(self, nOut: int = 512,
                 levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (128, 128, 256, 256, 512, 512),
                 dsp: bool = True, up_path: bool = True, gate: bool = True):
        super().__init__()
        self.levels = tuple(levels)
        self.Conv_0 = nn.Conv1d(1, channels[0], 3, 3, bias=False)
        self.BatchNorm_0 = bn_module(channels[0])
        n, cin = 1, channels[0]
        self.plain = []
        for li in range(2):
            names = []
            for _ in range(levels[li]):
                self.add_module(f"Conv_{n}", nn.Conv1d(cin, channels[li], 3,
                                                       padding=1, bias=False))
                self.add_module(f"BatchNorm_{n}", bn_module(channels[li]))
                names.append(n)
                n, cin = n + 1, channels[li]
            self.plain.append(names)
        self.stages = []
        blocks = 0
        for li in range(2, 6):
            if self.use_tree:
                name = f"Tree_{li - 2}"
                self.add_module(name, Tree(cin, levels[li], channels[li],
                                           level_root=li >= 3, dsp=dsp,
                                           up_path=up_path, gate=gate))
                self.stages.append([name])
            else:
                names = []
                for _ in range(levels[li]):
                    name = f"ElasticBottleneck_{blocks}"
                    self.add_module(name, ElasticBottleneck(
                        cin, channels[li], dsp, up_path, gate))
                    names.append(name)
                    blocks, cin = blocks + 1, channels[li]
                self.stages.append(names)
            cin = channels[li]
        C = channels[5]
        # attentive statistics pooling
        self.head_conv = (f"Conv_{n}", f"Conv_{n + 1}")
        self.add_module(self.head_conv[0], nn.Conv1d(C, C // 8, 1))
        self.add_module(f"BatchNorm_{n}", bn_module(C // 8))
        self.add_module(self.head_conv[1], nn.Conv1d(C // 8, C, 1))
        self.add_module(f"BatchNorm_{n + 1}", bn_module(2 * C))
        self.Dense_0 = nn.Linear(2 * C, nOut)
        self.add_module(f"BatchNorm_{n + 2}", bn_module(nOut))
        self.head_bn = [f"BatchNorm_{n + i}" for i in range(3)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → embeddings ``[B, nOut]``."""
        x = wrap_to_fixed(x)[:, None]
        x = torch.relu(batch_norm(self.BatchNorm_0,
                                  promoted(self.Conv_0, x)))
        for names in self.plain:
            for n in names:
                x = torch.relu(batch_norm(getattr(self, f"BatchNorm_{n}"),
                                          promoted(getattr(self, f"Conv_{n}"),
                                                   x)))
            x = max_pool1d(x, 3)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            x = max_pool1d(x, 3)

        bn_attn, bn_stats, bn_code = (getattr(self, n) for n in self.head_bn)
        attn = batch_norm(bn_attn, torch.relu(
            promoted(getattr(self, self.head_conv[0]), x)))
        w = torch.softmax(promoted(getattr(self, self.head_conv[1]), attn),
                          dim=2)
        m = torch.sum(x * w, dim=2)
        s = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - m * m,
                                   min=1e-5))
        h = batch_norm(bn_stats, torch.cat([m, s], dim=1))
        code = batch_norm(bn_code, promoted(self.Dense_0, h))
        if self.training:
            # training codes rescaled to norm 9
            norm = code.norm(dim=1, keepdim=True) / 9.0
            code = code / torch.clamp(norm, min=1e-12)
        return code


class RawNeXt(_NeXtBase):
    use_tree = True


class ResNeXt(_NeXtBase):
    use_tree = False


@MODELS.register("RawNeXt")
def build_rawnext(nOut: int = 512, **kwargs) -> RawNeXt:
    """RawNeXt at the reference's widths."""
    return RawNeXt(nOut=nOut)


@MODELS.register("ResNeXt")
def build_resnext(nOut: int = 512, **kwargs) -> ResNeXt:
    """ResNeXt at the reference's widths."""
    return ResNeXt(nOut=nOut)
