"""RawNet3 raw-waveform speaker encoder (port of ``models/rawnet3.py``).

Pre-emphasis and instance norm → sinc filterbank (|·|, optional log,
``mean``/``mean_std``/no normalization over time) → three Bottle2necks
(dilations 2/3/4, max pools 5/3/-), the third fed the summed skip
(``summed``) or the second's output → aggregation → 1×1 conv to the
context width → attentive pooling (``ASP``: one weight per step,
``ECA``: one per channel and step; with ``context``, over ``[x ∥ mean ∥
std]``) → BN → linear (→ BN with ``out_bn``). ``[B, T] -> [B, nOut]``.
Registered as ``RawNet3``; the ``Raw3_ECAPA`` hybrid takes the defaults.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from speakerverification_tpu_torch.models.layers import (
    batch_norm,
    bn_module,
)
from speakerverification_tpu_torch.models.rawnet_blocks import (
    Bottle2neckRaw,
    max_pool1d,
)
from speakerverification_tpu_torch.ops.frontend import pre_emphasis
from speakerverification_tpu_torch.ops.sinc import SincConv
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["RawNet3", "build_rawnet3"]

_NORM_SINC = ("mean", "mean_std", "none")
_ENCODERS = ("ASP", "ECA")


class RawNet3(nn.Module):
    def __init__(self, nOut: int = 512, C: int = 1024, model_scale: int = 8,
                 context: bool = True, summed: bool = True,
                 out_bn: bool = False, log_sinc: bool = True,
                 norm_sinc: str = "mean", encoder_type: str = "ASP",
                 sinc_stride: int = 10, sample_rate: int = 16000,
                 context_dim: int = 1536):
        super().__init__()
        if norm_sinc not in _NORM_SINC:
            raise ValueError(f"norm_sinc must be one of {_NORM_SINC}, got "
                             f"{norm_sinc!r}")
        if encoder_type not in _ENCODERS:
            raise ValueError(f"encoder_type must be one of {_ENCODERS}, got "
                             f"{encoder_type!r}")
        self.context, self.summed, self.out_bn = context, summed, out_bn
        self.log_sinc, self.norm_sinc = log_sinc, norm_sinc
        # sample_rate is kept for config parity only: the sinc grid is
        # pinned to 16 kHz, as the reference never threads its rate in
        self.sample_rate = sample_rate
        self.inorm_scale = nn.Parameter(torch.ones(1))
        self.inorm_bias = nn.Parameter(torch.zeros(1))
        self.SincConv_0 = SincConv(C // 4, kernel_size=251,
                                   stride=sinc_stride, sample_rate=16000)
        self.Bottle2neckRaw_0 = Bottle2neckRaw(C // 4, C, 3, 2, model_scale,
                                               pool=5)
        self.Bottle2neckRaw_1 = Bottle2neckRaw(C, C, 3, 3, model_scale, pool=3)
        self.Bottle2neckRaw_2 = Bottle2neckRaw(C, C, 3, 4, model_scale)
        self.Conv_0 = nn.Conv1d(3 * C, context_dim, 1)
        self.Conv_1 = nn.Conv1d((3 if context else 1) * context_dim, 128, 1)
        self.BatchNorm_0 = bn_module(128)
        self.Conv_2 = nn.Conv1d(128, context_dim if encoder_type == "ECA"
                                else 1, 1)
        self.BatchNorm_1 = bn_module(2 * context_dim)
        self.Dense_0 = nn.Linear(2 * context_dim, nOut)
        if out_bn:
            self.BatchNorm_2 = bn_module(nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → ``[B, nOut]``."""
        # pre-emphasis + instance norm (eps 1e-4), pinned to fp32
        wave_dtype = x.dtype
        x = pre_emphasis(x.float())
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        x = ((x - mean) / torch.sqrt(var + 1e-4) * self.inorm_scale.float()
             + self.inorm_bias.float())
        x = x.to(wave_dtype)

        # sinc filterbank in the wave's dtype; |·|, log and the norm over
        # time in fp32
        x = self.SincConv_0(x)                              # [B, C/4, F]
        in_dtype = x.dtype
        x = x.abs().float()
        if self.log_sinc:
            x = torch.log(x + 1e-6)
        if self.norm_sinc == "mean":
            x = x - x.mean(dim=2, keepdim=True)
        elif self.norm_sinc == "mean_std":
            # the unbiased std, clamped at 1e-3
            s = torch.clamp(x.std(dim=2, keepdim=True), min=1e-3)
            x = (x - x.mean(dim=2, keepdim=True)) / s
        x = x.to(in_dtype)

        x1 = self.Bottle2neckRaw_0(x)
        x2 = self.Bottle2neckRaw_1(x1)
        x3 = self.Bottle2neckRaw_2(max_pool1d(x1, 3) + x2 if self.summed
                                   else x2)

        # aggregation, truncated to the common length
        p1 = max_pool1d(x1, 3)
        L = min(p1.shape[2], x2.shape[2], x3.shape[2])
        agg = torch.cat([p1[..., :L], x2[..., :L], x3[..., :L]], dim=1)
        x = torch.relu(self.Conv_0(agg))                     # [B, 1536, L]

        glob = x
        if self.context:
            # time mean and unbiased std (ddof=1), clipped
            mu = x.mean(dim=2, keepdim=True)
            sg = torch.sqrt(torch.clamp(x.var(dim=2, keepdim=True), 1e-4,
                                        1e4))
            glob = torch.cat([x, mu.expand_as(x), sg.expand_as(x)], dim=1)

        attn = batch_norm(self.BatchNorm_0, torch.relu(self.Conv_1(glob)))
        w = torch.softmax(self.Conv_2(attn), dim=2)          # over time

        mu = torch.sum(x * w, dim=2)
        sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu,
                                    1e-4, 1e4))
        x = batch_norm(self.BatchNorm_1, torch.cat([mu, sg], dim=1))
        x = self.Dense_0(x)
        if self.out_bn:
            x = batch_norm(self.BatchNorm_2, x)
        return x


@MODELS.register("RawNet3")
def build_rawnet3(nOut: int = 512, model_scale: int = 8, context: bool = True,
                  summed: bool = True, out_bn: bool = False,
                  log_sinc: bool = True, norm_sinc: str = "mean",
                  encoder_type: str = "ASP", sinc_stride: int = 10,
                  C: int = 1024, **kwargs) -> RawNet3:
    """RawNet3 with the reference's options; ``sample_rate`` (or
    ``audio_spec.sample_rate``) is recorded, not used (see the module)."""
    sr = int(kwargs.get("sample_rate",
                        (kwargs.get("audio_spec") or {}).get("sample_rate",
                                                             16000)))
    return RawNet3(nOut=nOut, C=C, model_scale=model_scale, context=context,
                   summed=summed, out_bn=out_bn, log_sinc=log_sinc,
                   norm_sinc=norm_sinc, encoder_type=encoder_type,
                   sinc_stride=sinc_stride, sample_rate=sr)
