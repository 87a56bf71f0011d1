"""Post-training integer quantization of the reference model, written
from the scheme's description: symmetric, per output channel for the
weights (``s_w = max|w| / q``, by division), one static per-tensor scale
for each layer's input (``s_x = 1.1 · max|x| / q`` over a calibration
batch, applied as a multiplication by ``1 / s_x``), rounding to nearest,
clipped to ``±q`` with ``q = 2^(bits-1) - 1``; integer products summed,
then ``acc · s_w · s_x + bias``.

Which layers: every stride-1, ungrouped, zero-padded ``nn.Conv1d`` with
``taps · in_channels >= 512`` and ``out_channels >= 128`` called on a
``[B, C, T]`` input, and every ``nn.Linear`` with ``in >= 512`` and
``out >= 128`` called on a batch. ECAPA's attentive pooling computes its
attention convolution from the weight's rows (the mean and deviation
terms are constants over time), so that layer stays in float.

``bits=8`` is the configuration's int8; ``bits=4`` is its control."""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from svbench.reference.models import ECAPA

__all__ = ["quantizable", "calibrate", "quantized", "FakeQuantConv1d",
           "FakeQuantLinear", "gemm_shapes"]

MIN_K, MIN_N, MARGIN = 512, 128, 1.1


def _float_layers(model: nn.Module) -> set:
    """Names of layers that stay float whatever their size."""
    return {f"{name}.AttentiveStatisticsPooling_0.TDNNBlock_0.Conv1d_0.Conv_0"
            .lstrip(".") for name, m in model.named_modules()
            if isinstance(m, ECAPA)}


def quantizable(m: nn.Module) -> bool:
    if type(m) is nn.Linear:
        return m.in_features >= MIN_K and m.out_features >= MIN_N
    if type(m) is nn.Conv1d:
        return (m.stride == (1,) and m.groups == 1
                and m.padding_mode == "zeros"
                and m.kernel_size[0] * m.in_channels >= MIN_K
                and m.out_channels >= MIN_N)
    return False


def _targets(model: nn.Module) -> dict:
    skip = _float_layers(model)
    return {n: m for n, m in model.named_modules()
            if quantizable(m) and n not in skip}


@torch.no_grad()
def calibrate(model: nn.Module, waves: torch.Tensor) -> dict:
    """``{layer: 1.1 · max|input|}`` over one eval forward of ``waves``
    through ``model.embed``, for each quantized layer that is called."""
    scales: dict = {}

    def hook(name):
        def fn(mod, inputs):
            x = inputs[0]
            if x.dim() >= 2 if type(mod) is nn.Linear else x.dim() == 3:
                scales[name] = max(scales.get(name, 0.0),
                                   float(x.float().abs().max()))
        return fn

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in _targets(model).items()]
    try:
        model.eval().embed(waves)
    finally:
        for h in handles:
            h.remove()
    return {k: v * MARGIN for k, v in scales.items()}


class _FakeQuant(nn.Module):
    def __init__(self, weight_nk: torch.Tensor, bias, act_scale: float,
                 bits: int):
        super().__init__()
        q = float(2 ** (bits - 1) - 1)
        w = weight_nk.detach().float()
        s_w = torch.clamp(w.abs().amax(dim=1, keepdim=True) / q, min=1e-12)
        self.register_buffer("wq", torch.clamp(torch.round(w / s_w), -q, q))
        self.register_buffer("s_w", s_w[:, 0])
        self.bias = None if bias is None else bias.detach().float()
        self.q = q
        self.s_x = max(act_scale / q, 1e-12)
        self.inv_sx = float(np.float32(1.0 / self.s_x))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x.float() * self.inv_sx), -self.q,
                           self.q)

    def finish(self, acc: torch.Tensor, channel_dim: int) -> torch.Tensor:
        shape = [1] * acc.dim()
        shape[channel_dim] = -1
        scale = (self.s_w * float(np.float32(self.s_x))).view(shape)
        out = acc * scale
        return out if self.bias is None else out + self.bias.view(shape)


class FakeQuantConv1d(_FakeQuant):
    def __init__(self, m: nn.Conv1d, act_scale: float, bits: int):
        # [out, in, k] -> [out, k * in]: tap-major rows
        super().__init__(m.weight.permute(0, 2, 1).reshape(m.out_channels, -1),
                         m.bias, act_scale, bits)
        self.k, self.cin = m.kernel_size[0], m.in_channels
        self.dilation, self.padding = m.dilation, m.padding

    def forward(self, x):
        w = self.wq.view(self.wq.shape[0], self.k, self.cin).permute(0, 2, 1)
        acc = F.conv1d(self.quantize(x), w.contiguous(),
                       dilation=self.dilation, padding=self.padding)
        return self.finish(acc, 1)


class FakeQuantLinear(_FakeQuant):
    def __init__(self, m: nn.Linear, act_scale: float, bits: int):
        super().__init__(m.weight, m.bias, act_scale, bits)

    def forward(self, x):
        return self.finish(self.quantize(x) @ self.wq.T, -1)


def quantized(model: nn.Module, scales: dict, bits: int = 8) -> nn.Module:
    """A copy of ``model`` with every calibrated layer in ``bits``-bit
    integers."""
    model = copy.deepcopy(model)
    for name, m in _targets(model).items():
        if name not in scales:
            continue
        kind = FakeQuantLinear if type(m) is nn.Linear else FakeQuantConv1d
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent), child,
                kind(m, scales[name], bits))
    return model.eval()


def gemm_shapes(model: nn.Module, samples: int, batch: int) -> list:
    """``[(M, K, N)]`` of each quantized layer's product in one forward of
    ``batch`` crops of ``samples`` (on the meta device): M rows (batch ×
    steps for a conv), K = taps × in, N = out."""
    shapes = []
    meta = copy.deepcopy(model).to("meta").eval()

    def hook(mod, inputs):
        x = inputs[0]
        if type(mod) is nn.Linear:
            shapes.append((int(np.prod(x.shape[:-1])), mod.in_features,
                           mod.out_features))
        else:
            t_out = x.shape[2] + 2 * mod.padding[0] \
                - mod.dilation[0] * (mod.kernel_size[0] - 1)
            shapes.append((x.shape[0] * t_out,
                           mod.kernel_size[0] * mod.in_channels,
                           mod.out_channels))

    handles = [m.register_forward_pre_hook(hook)
               for m in _targets(meta).values()]
    try:
        with torch.no_grad():
            meta.embed(torch.zeros(batch, samples, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return shapes
