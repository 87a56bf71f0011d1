"""RawNet2 with a choice of front and aggregation (port of
``models/rawnet2_custom.py``).

Front ``sinc`` (the sample LayerNorm, SincConv_fast, |·|, max pool 3,
BN, lrelu) or ``conv`` (a 3-tap conv of stride 3); six groups of
pre-activation ``RawNetBasicBlock``s (``layers`` blocks each, the last
block of a group max-pooled by 3); BN → lrelu; then aggregation ``gru``
(the GRU's last state), ``asp`` (attentive statistics pooling) or
``sap`` (self-attentive pooling with the reference's mean/sum
asymmetry); a linear embedding. ``[B, T] -> [B, nOut]``.

The flax auto-names depend on the front: with ``sinc`` the front's BN
is ``BatchNorm_0`` and the closing one ``BatchNorm_1``; with ``conv``
the front conv is ``Conv_0`` and the closing BN ``BatchNorm_0``; the
aggregation's layers number on from there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.models.layers import (
    at_least_fp32,
    batch_norm,
    bn_module,
    promoted,
)
from speakerverification_tpu_torch.models.rawnet2 import (
    crop_samples,
    run_sinc_front,
    sample_rate_of,
    sinc_front,
)
from speakerverification_tpu_torch.models.rawnet_blocks import (
    RawNetBasicBlock,
    leaky_relu_03,
)
from speakerverification_tpu_torch.models.recurrent import GRUCell
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["RawNet2Custom", "build_rawnet2_custom"]


class RawNet2Custom(nn.Module):
    def __init__(self, nOut: int = 512,
                 layers: Tuple[int, ...] = (1, 1, 1, 2, 1, 2),
                 filters: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
                 front_proc: str = "sinc", aggregate: str = "asp",
                 att_dim: int = 128, gru_node: int = 1024,
                 nb_gru_layers: int = 1, first_conv_size: int = 251,
                 sample_rate: int = 16000, n_samples: Optional[int] = None):
        super().__init__()
        if front_proc not in ("sinc", "conv"):
            raise ValueError(f"unknown front_proc {front_proc!r}")
        if aggregate not in ("asp", "gru", "sap"):
            raise ValueError(f"unknown aggregate {aggregate!r}")
        self.front_proc, self.aggregate = front_proc, aggregate
        n_bn = n_conv = 0
        if front_proc == "sinc":
            if n_samples is None:
                raise ValueError("the sinc front needs n_samples, the crop "
                                 "length its sample LayerNorm is built for")
            self.SampleLayerNorm_0, self.SincConv_0 = sinc_front(
                n_samples, filters[0], first_conv_size, sample_rate)
            self.BatchNorm_0 = bn_module(filters[0])
            n_bn = 1
        else:
            self.Conv_0 = nn.Conv1d(1, filters[0], 3, stride=3)
            n_conv = 1

        self.blocks = []
        cin = filters[0]
        for planes, n_blocks in zip(filters, layers):
            for b in range(n_blocks):
                name = f"RawNetBasicBlock_{len(self.blocks)}"
                self.add_module(name, RawNetBasicBlock(
                    cin, planes, downsample=(b == n_blocks - 1)))
                self.blocks.append(name)
                cin = planes

        self.bn_out = f"BatchNorm_{n_bn}"
        self.add_module(self.bn_out, bn_module(cin))
        if aggregate == "gru":
            self.n_gru = nb_gru_layers
            for i in range(nb_gru_layers):
                self.add_module(f"GRUCell_{i}", GRUCell(
                    cin if i == 0 else gru_node, gru_node))
            self.Dense_0 = nn.Linear(gru_node, nOut)
        elif aggregate == "sap":
            self.Dense_0 = nn.Linear(cin, cin)
            self.sap_v = nn.Parameter(torch.randn(cin))
            # drawn by weights.init_weights_ as flax's normal(1.0)
            self.normal_params = ("sap_v",)
            self.Dense_1 = nn.Linear(2 * cin, nOut)
        else:
            self.asp_names = (f"Conv_{n_conv}", f"BatchNorm_{n_bn + 1}",
                              f"Conv_{n_conv + 1}")
            for name, m in zip(self.asp_names, (
                    nn.Conv1d(cin, att_dim, 1), bn_module(att_dim),
                    nn.Conv1d(att_dim, cin, 1))):
                self.add_module(name, m)
            self.Dense_0 = nn.Linear(2 * cin, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → ``[B, nOut]``."""
        if self.front_proc == "conv":
            x = self.Conv_0(x[:, None, :])
        else:
            x = run_sinc_front(self.SampleLayerNorm_0, self.SincConv_0,
                               self.BatchNorm_0, x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = leaky_relu_03(batch_norm(getattr(self, self.bn_out), x))

        if self.aggregate == "gru":
            x = x.transpose(1, 2)
            for i in range(self.n_gru):
                x = getattr(self, f"GRUCell_{i}")(x)         # [B, L, H]
            return promoted(self.Dense_0, x[:, -1, :])

        if self.aggregate == "sap":
            # softmax over time of tanh((x W) · v); the pooled mean is a
            # mean over time but the second moment a sum (the
            # reference's asymmetry, kept)
            xt = x.transpose(1, 2)                           # [B, L, C]
            h = self.Dense_0(xt)
            w = torch.softmax(torch.tanh(h @ self.sap_v), dim=1)[..., None]
            xw = xt * w
            mean = at_least_fp32(xw).mean(dim=1).to(xw.dtype)
            var = torch.sum(xt * xw, dim=1) - mean * mean
            return self.Dense_1(torch.cat([mean, var], dim=-1))

        conv_a, bn, conv_b = (getattr(self, n) for n in self.asp_names)
        attn = batch_norm(bn, F.leaky_relu(conv_a(x), 0.01))
        w = torch.softmax(conv_b(attn), dim=2)               # over time
        m = torch.sum(x * w, dim=2)
        s = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - m * m,
                                   min=1e-5))
        return self.Dense_0(torch.cat([m, s], dim=-1))


@MODELS.register("RawNet2_custom")
def build_rawnet2_custom(nOut: int = 512, front_proc: str = "sinc",
                         aggregate: str = "gru", att_dim: int = 128,
                         **kwargs) -> RawNet2Custom:
    """The reference's default RawNet2_custom (sinc front, GRU), the sinc
    bank's rate from the config and its LayerNorm sized to its crops."""
    return RawNet2Custom(nOut=nOut, front_proc=front_proc,
                         aggregate=aggregate, att_dim=att_dim,
                         sample_rate=sample_rate_of(kwargs),
                         n_samples=crop_samples(kwargs))
