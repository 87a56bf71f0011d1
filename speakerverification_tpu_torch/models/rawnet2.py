"""RawNet2 raw-waveform speaker encoder (port of ``models/rawnet2.py``).

Sample-axis LayerNorm → SincConv(128, 251) on SincConv_fast's linspace
window grid → |·| → max pool 3 → BN → lrelu(0.3) → six FRM residual
blocks → BN → lrelu → GRU(1024), whose last state → linear embedding.
``[B, T] -> [B, nOut]``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn

from speakerverification_tpu_torch.data.audio import AudioSpec
from speakerverification_tpu_torch.models.layers import (
    at_least_fp32,
    batch_norm,
    bn_module,
    promoted,
)
from speakerverification_tpu_torch.models.rawnet_blocks import (
    ResidualBlockFRM,
    leaky_relu_03,
    max_pool1d,
)
from speakerverification_tpu_torch.models.recurrent import GRUCell
from speakerverification_tpu_torch.ops.sinc import SincConv
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["SampleLayerNorm", "RawNet2", "build_rawnet2", "crop_samples",
           "sample_rate_of", "sinc_front", "run_sinc_front"]


def crop_samples(kwargs: Mapping) -> int:
    """The crop length in samples that ``audio_spec`` gives the loaders
    (``sentence_len · sample_rate``): the length a sample-axis LayerNorm
    is built for, as the JAX package builds it from its template crop."""
    return AudioSpec(kwargs.get("audio_spec") or {}).max_audio


def sample_rate_of(kwargs: Mapping, default: int = 16000) -> int:
    """``sample_rate`` of the model's keys, else of ``audio_spec``, else
    ``default``, as the JAX RawNet2 builders read it."""
    return int(kwargs.get("sample_rate",
                          (kwargs.get("audio_spec") or {}).get("sample_rate",
                                                               default)))


class SampleLayerNorm(nn.Module):
    """LayerNorm over the samples of each wave with a per-sample affine
    (``gamma``, ``beta`` of the crop's length ``T``): the unbiased std,
    with eps added to the std, not to the variance. The statistics are
    reduced in fp32 at least and returned in x's dtype, as ``jnp.mean``
    and ``jnp.var`` reduce a bf16 wave."""

    def __init__(self, n_samples: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(n_samples))
        self.beta = nn.Parameter(torch.zeros(n_samples))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.gamma.shape[0]:
            raise ValueError(
                f"a {x.shape[-1]}-sample wave, but this model's sample "
                f"LayerNorm was built for {self.gamma.shape[0]}-sample "
                "crops (audio_spec sentence_len x sample_rate)")
        xf = at_least_fp32(x)
        mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
        std = torch.sqrt(xf.var(dim=-1, keepdim=True).to(x.dtype))
        return self.gamma * (x - mean) / (std + self.eps) + self.beta


def sinc_front(n_samples: int, filters: int, kernel_size: int,
               sample_rate: int) -> tuple[SampleLayerNorm, SincConv]:
    """The RawNet2 family's sinc front: the sample LayerNorm and
    SincConv_fast (mel init from 10 Hz, linspace window grid)."""
    return (SampleLayerNorm(n_samples),
            SincConv(filters, kernel_size, sample_rate=sample_rate,
                     init_low_hz=10.0, window_grid="linspace"))


def run_sinc_front(norm: SampleLayerNorm, sinc: SincConv,
                   bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``[B, T] -> [B, C, F]``: LayerNorm, sinc, |·|, max pool 3, BN,
    lrelu(0.3)."""
    x = max_pool1d(sinc(norm(x)).abs(), 3)
    return leaky_relu_03(batch_norm(bn, x))


class RawNet2(nn.Module):
    """The embedding is the linear map of the GRU's last state; ``nOut``
    plays the reference's ``nb_fc_node`` role."""

    def __init__(self, nOut: int = 512, first_filters: int = 128,
                 block_filters: Tuple[Tuple[int, int], ...] = (
                     (128, 128), (128, 128), (128, 256), (256, 256),
                     (256, 256), (256, 256)),
                 first_conv_size: int = 251, gru_node: int = 1024,
                 nb_gru_layer: int = 1, sample_rate: int = 16000,
                 n_samples: Optional[int] = None):
        super().__init__()
        if n_samples is None:
            raise ValueError("RawNet2 needs n_samples, the crop length its "
                             "sample LayerNorm is built for")
        self.SampleLayerNorm_0, self.SincConv_0 = sinc_front(
            n_samples, first_filters, first_conv_size, sample_rate)
        self.BatchNorm_0 = bn_module(first_filters)
        self.n_blocks = len(block_filters)
        for i, (fin, fout) in enumerate(block_filters):
            self.add_module(f"ResidualBlockFRM_{i}",
                            ResidualBlockFRM(fin, fout, first=(i == 0)))
        last = block_filters[-1][1]
        self.BatchNorm_1 = bn_module(last)
        self.n_gru = nb_gru_layer
        for i in range(nb_gru_layer):
            self.add_module(f"GRUCell_{i}",
                            GRUCell(last if i == 0 else gru_node, gru_node))
        self.Dense_0 = nn.Linear(gru_node, nOut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: raw waveform ``[B, T]`` → ``[B, nOut]``."""
        x = run_sinc_front(self.SampleLayerNorm_0, self.SincConv_0,
                           self.BatchNorm_0, x)
        for i in range(self.n_blocks):
            x = getattr(self, f"ResidualBlockFRM_{i}")(x)
        x = leaky_relu_03(batch_norm(self.BatchNorm_1, x)).transpose(1, 2)
        for i in range(self.n_gru):
            x = getattr(self, f"GRUCell_{i}")(x)             # [B, L, H]
        return promoted(self.Dense_0, x[:, -1, :])


@MODELS.register("RawNet2", aliases=("RawNet_baseline",))
def build_rawnet2(nOut: int = 512, **kwargs) -> RawNet2:
    """RawNet2 at the reference's widths; the sinc bank's sample rate
    from the config, its LayerNorm sized to the config's crops."""
    return RawNet2(nOut=nOut, sample_rate=sample_rate_of(kwargs),
                   n_samples=crop_samples(kwargs))
