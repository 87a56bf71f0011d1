"""ECAPA-TDNN speaker embedding encoder (port of ``models/ecapa_tdnn.py``).

Initial TDNN → SE-Res2Net blocks (dilations 2/3/4) → multi-layer
feature aggregation → TDNN → attentive statistics pooling → BatchNorm
→ linear projection. Takes features ``[B, frames, n_mels]`` like the
JAX module and returns ``[B, lin_neurons]``; inside, activations are
``[B, C, frames]``.

``remat`` recomputes each SE-Res2Net block in the backward pass of a
training forward instead of keeping its activations (JAX's
``nn.remat``); eval ignores it, as the JAX engine drops it. The module
names, and so the ``state_dict`` keys, are the same either way.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from speakerverification_tpu_torch.models.layers import (
    AttentiveStatisticsPooling,
    BatchNorm1d,
    SERes2NetBlock,
    TDNNBlock,
    feature_dim,
    frozen_running_stats,
    gelu_exact,
    promoted,
)
from speakerverification_tpu_torch.registry import MODELS

__all__ = ["ECAPA_TDNN", "build_ecapa_tdnn"]


class ECAPA_TDNN(nn.Module):
    def __init__(self, n_mels: int = 80, lin_neurons: int = 192,
                 channels: Sequence[int] = (1024, 1024, 1024, 1024, 3072),
                 kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
                 dilations: Sequence[int] = (1, 2, 3, 4, 1),
                 attention_channels: int = 128, res2net_scale: int = 8,
                 se_channels: int = 128, global_context: bool = True,
                 activation: Callable = gelu_exact,
                 feature_type: str = "melspectrogram",
                 log_input: bool = True, input_norm: bool = False,
                 conv_backend: str = "xla", remat: bool = False):
        super().__init__()
        self.remat = remat
        if not len(channels) == len(kernel_sizes) == len(dilations):
            raise ValueError("channels, kernel_sizes and dilations differ "
                             "in length")
        self.feature_type, self.log_input = feature_type, log_input
        self.input_norm = input_norm
        if input_norm:
            self.input_norm_scale = nn.Parameter(torch.ones(n_mels))
            self.input_norm_bias = nn.Parameter(torch.zeros(n_mels))
        self.TDNNBlock_0 = TDNNBlock(n_mels, channels[0], kernel_sizes[0],
                                     dilations[0], activation=activation)
        self.n_blocks = len(channels) - 2
        for i in range(1, len(channels) - 1):
            self.add_module(f"SERes2NetBlock_{i - 1}", SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale=res2net_scale,
                se_channels=se_channels, kernel_size=kernel_sizes[i],
                dilation=dilations[i], activation=activation,
                conv_backend=conv_backend))
        self.TDNNBlock_1 = TDNNBlock(sum(channels[1:-1]), channels[-1],
                                     kernel_sizes[-1], dilations[-1],
                                     activation=activation)
        self.AttentiveStatisticsPooling_0 = AttentiveStatisticsPooling(
            channels[-1], attention_channels, global_context)
        self.BatchNorm1d_0 = BatchNorm1d(2 * channels[-1])
        self.Dense_0 = nn.Linear(2 * channels[-1], lin_neurons)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x``: features ``[B, frames, n_mels]`` → ``[B, lin_neurons]``."""
        if self.feature_type == "melspectrogram" and self.log_input:
            # log-compression + mean subtraction over time
            x = torch.log(torch.clamp(x, min=0.0) + 1e-6)
            x = x - x.mean(dim=1, keepdim=True)
        if self.input_norm:
            # per-utterance instance norm over time (biased variance)
            mean = x.mean(dim=1, keepdim=True)
            var = x.var(dim=1, unbiased=False, keepdim=True)
            x = ((x - mean) / torch.sqrt(var + 1e-5) * self.input_norm_scale
                 + self.input_norm_bias)
        x = self.TDNNBlock_0(x.transpose(1, 2))               # [B, C, frames]
        block_outputs = []
        for i in range(self.n_blocks):
            x = self._block(getattr(self, f"SERes2NetBlock_{i}"), x, lengths)
            block_outputs.append(x)
        # multi-layer feature aggregation over the SE-Res2Net outputs
        x = self.TDNNBlock_1(torch.cat(block_outputs, dim=1))
        x = self.AttentiveStatisticsPooling_0(x, lengths)     # [B, 2C]
        x = self.BatchNorm1d_0(x)
        return promoted(self.Dense_0, x)

    def _block(self, block: SERes2NetBlock, x: torch.Tensor,
               lengths: Optional[torch.Tensor]) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(x, lengths)
        # the block's tensors as this forward sees them (the train step's
        # bf16 copies live only inside its functional_call), so that the
        # recomputation uses the same ones; it leaves the BatchNorm
        # running statistics as the forward updated them, and the block
        # draws no random numbers
        tensors = {**dict(block.named_parameters()),
                   **dict(block.named_buffers())}
        return checkpoint(
            functional_call, block, tensors, (x, lengths),
            use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                frozen_running_stats()))


@MODELS.register("ECAPA_TDNN")
def build_ecapa_tdnn(nOut: int = 192, **kwargs) -> ECAPA_TDNN:
    """Factory keyed by ``model.name: ECAPA_TDNN``."""
    known = {k: kwargs[k] for k in (
        "channels", "kernel_sizes", "dilations", "attention_channels",
        "res2net_scale", "se_channels", "global_context", "input_norm",
        "log_input", "activation", "conv_backend", "remat") if k in kwargs}
    for k in ("channels", "kernel_sizes", "dilations"):
        if k in known:
            known[k] = tuple(known[k])
    feature_type = kwargs.get("feature_type", kwargs.get("features", "melspectrogram"))
    return ECAPA_TDNN(n_mels=feature_dim(kwargs), lin_neurons=nOut,
                      feature_type=feature_type, **known)
