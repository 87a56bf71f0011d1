"""Shared ECAPA building blocks (port of ``models/layers.py``).

Activations are channels-first, ``[B, C, T]``, as PyTorch's convolutions
want them (the JAX package keeps ``[B, T, C]``). Child modules carry the
flax scope names of their JAX counterparts (``Conv1d_0``,
``BatchNorm1d_0``, ``TDNNBlock_3``, ...), so a ``state_dict`` key is the
flax parameter path with dots (``weights.params_from_jax``).

ECAPA convolutions reflect-pad to 'same' length (SpeechBrain's default);
the RawNet blocks zero-pad.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.ops.frontend import use_kernel
from speakerverification_tpu_torch.ops.res2net_cascade import (
    invalidate_packed,
    res2net_cascade,
    state_version,
)

__all__ = [
    "promoted",
    "at_least_fp32",
    "gelu_exact",
    "length_to_mask",
    "feature_dim",
    "batch_norm",
    "frozen_running_stats",
    "Dropout",
    "bn_module",
    "Conv1d",
    "folded_constants",
    "BatchNorm1d",
    "TDNNBlock",
    "Res2NetBlock",
    "SEBlock",
    "AttentiveStatisticsPooling",
    "SERes2NetBlock",
]


def promoted(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` for a conv (1-D, 2-D, transposed) or linear layer;
    where x and the weights differ in dtype (bf16 weights after an fp32
    reduction),
    both are promoted to the wider one first, as jnp promotes a bf16 kernel
    against an fp32 input. The module is still called (its hooks run,
    as int8 calibration's do)."""
    w = getattr(module, "weight", None)
    if not isinstance(module, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                               nn.Linear)) \
            or w.dtype == x.dtype:
        return module(x)
    dt = torch.promote_types(x.dtype, w.dtype)
    promoted_weights = {"weight": w.to(dt)}
    if module.bias is not None:
        promoted_weights["bias"] = module.bias.to(dt)
    return torch.func.functional_call(module, promoted_weights, (x.to(dt),))


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32 when its dtype is narrower (bf16), else as it is:
    the dtype in which ``jnp.mean``/``jnp.var`` reduce a bf16 input."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def feature_dim(kwargs) -> int:
    """The width of the features a model's builder is handed: ``n_mfcc``
    for ``mfcc``, ``n_fft // 2 + 1`` bins for ``spectrogram``, else
    ``n_mels`` (the JAX modules read it from their input)."""
    feature_type = kwargs.get("feature_type",
                              kwargs.get("features", "melspectrogram"))
    if feature_type == "mfcc":
        return int(kwargs.get("n_mfcc", 80))
    if feature_type == "spectrogram":
        return int(kwargs.get("n_fft", 512)) // 2 + 1
    return int(kwargs.get("n_mels", 80))


def length_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[B] -> [B, max_len]`` float mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


_bn_state = threading.local()


@contextlib.contextmanager
def frozen_running_stats() -> Iterator[None]:
    """Train-mode :func:`batch_norm` in this thread normalizes as always
    but leaves the running statistics alone: the backward pass's
    recomputation of a checkpointed block (``remat``) must not update
    them a second time."""
    was = getattr(_bn_state, "frozen", False)
    _bn_state.frozen = True
    try:
        yield
    finally:
        _bn_state.frozen = was


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` over the channels of ``x`` (``[B, C, ...]``: the channel axis
    is 1, any rank), as flax's ``nn.BatchNorm(momentum=0.9)`` computes it;
    returns x's dtype.

    Training mode normalizes with the biased batch statistics, computed
    in fp32 at least whatever x's dtype (E[x²] − E[x]², clipped at 0), and
    updates the fp32 running statistics as flax does: ``ra = 0.9·ra +
    0.1·stat``, with the biased variance (torch's own update takes the
    unbiased one). Eval mode is ``bn(x)``'s ``F.batch_norm`` (which, unlike
    ``nn.BatchNorm1d``, takes any rank); when the parameters were cast
    to a lower precision than the running statistics (mixed-precision
    eval), the affine is computed in fp32."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if bn.training:
        dims = [0] + list(range(2, x.dim()))
        # fp32 at least, as flax promotes its statistics
        xf = at_least_fp32(x)
        mean = xf.mean(dims)
        var = torch.clamp(torch.square(xf).mean(dims) - torch.square(mean),
                          min=0.0)
        if not getattr(_bn_state, "frozen", False):
            with torch.no_grad():
                m = 1.0 - bn.momentum
                bn.running_mean.copy_(m * bn.running_mean
                                      + (1.0 - m) * mean.detach())
                bn.running_var.copy_(m * bn.running_var
                                     + (1.0 - m) * var.detach())
        mul = torch.rsqrt(var + bn.eps) * bn.weight.to(xf.dtype)
        y = ((xf - mean.view(shape)) * mul.view(shape)
             + bn.bias.to(xf.dtype).view(shape))
        return y.to(x.dtype)
    if x.dtype == bn.weight.dtype == bn.running_mean.dtype:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    t = bn.bias.float() - bn.running_mean.float() * s
    return (x.float() * s.view(shape) + t.view(shape)).to(x.dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training, each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask
    comes from ``rng``, a ``torch.Generator`` on x's device. Off in eval
    and at rate 0, where no generator is needed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("a training forward with dropout needs a "
                             "torch.Generator (rng)")
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, zero)


def bn_module(features: int) -> nn.BatchNorm1d:
    """The container of one BatchNorm's parameters and running statistics
    (eps 1e-5; torch momentum 0.1 is flax's 0.9), run by
    :func:`batch_norm`."""
    return nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)


class Conv1d(nn.Module):
    """1-D conv, 'same' length with REFLECT padding, which it applies
    only when ``dilation*(kernel_size-1) > 0``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.pad = dilation * (kernel_size - 1)
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad > 0:
            x = F.pad(x, (self.pad // 2, self.pad - self.pad // 2),
                      mode="reflect")
        return promoted(self.Conv_0, x)


class BatchNorm1d(nn.Module):
    """BatchNorm over channels, eps 1e-5 (flax momentum 0.9)."""

    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = bn_module(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self.BatchNorm_0, x)


class TDNNBlock(nn.Module):
    """Conv → activation → BatchNorm."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1, activation: Callable = gelu_exact):
        super().__init__()
        self.activation = activation
        self.Conv1d_0 = Conv1d(in_channels, features, kernel_size, dilation)
        self.BatchNorm1d_0 = BatchNorm1d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm1d_0(self.activation(self.Conv1d_0(x)))


class Res2NetBlock(nn.Module):
    """Multi-scale residual block: channels split into ``scale`` groups;
    group 0 passes through, each later group is a k-tap ReLU TDNN with
    the previous group's output added in (the inner TDNNs always use
    ReLU, whatever the outer activation).

    ``backend``: ``'xla'`` runs the plain convs, ``'pallas'`` the
    hand-written cascade kernel (``ops/res2net_cascade.py``), ``'auto'``
    the kernel on CUDA. The kernel serves eval mode only; its BatchNorm
    is folded to a per-channel affine here."""

    def __init__(self, features: int, scale: int = 8, kernel_size: int = 3,
                 dilation: int = 1, backend: str = "xla"):
        super().__init__()
        if features % scale:
            raise ValueError(f"features {features} not divisible by "
                             f"scale {scale}")
        self.features, self.scale = features, scale
        self.kernel_size, self.dilation, self.backend = kernel_size, dilation, backend
        hidden = features // scale
        self._folded = None   # (state key, folded weights): see folded()
        self._frozen = False  # see folded_constants()
        for j in range(scale - 1):
            self.add_module(f"TDNNBlock_{j}", TDNNBlock(
                hidden, hidden, kernel_size, dilation, activation=torch.relu))

    def blocks(self) -> list[TDNNBlock]:
        return [getattr(self, f"TDNNBlock_{j}") for j in range(self.scale - 1)]

    def _use_fused(self, x: torch.Tensor) -> bool:
        # a shape the kernel cannot take (kernel_size != 3, a crop of
        # T <= 2*dilation) raises in the wrapper; it never falls back
        return use_kernel(self.backend, x) and not self.training

    def folded(self):
        """Stacked cascade weights ``[s-1, 3, H, H]`` (tap, in, out), conv
        bias and the eval BatchNorm folded to scale and shift.

        Kept until a parameter or buffer changes storage, dtype or
        version (``load_state_dict``, ``.to()``, a training step, an
        in-place edit), so the kernel's wrapper finds the same weights
        tensor, and its packed weights, on every eval forward. An edit
        that no version counter records is not seen: after one, call
        :meth:`invalidate_folded`."""
        key = tuple((p.data_ptr(), state_version(p), p.dtype)
                    for p in (*self.parameters(), *self.buffers()))
        if self._folded is None or self._folded[0] != key:
            ws, cbs, ss, bs = [], [], [], []
            # plain tensors even under inference mode, so that they carry
            # the version counter the wrapper's packed weights key on
            with torch.inference_mode(False), torch.no_grad():
                for blk in self.blocks():
                    conv = blk.Conv1d_0.Conv_0
                    bn = blk.BatchNorm1d_0.BatchNorm_0
                    s = bn.weight.float() * torch.rsqrt(
                        bn.running_var.float() + bn.eps)
                    ws.append(conv.weight.permute(2, 1, 0))
                    cbs.append(conv.bias.float())
                    ss.append(s)
                    bs.append(bn.bias.float() - bn.running_mean.float() * s)
                self._folded = (key, (torch.stack(ws), torch.stack(cbs),
                                      torch.stack(ss), torch.stack(bs)))
        return self._folded[1]

    def invalidate_folded(self) -> None:
        """Forget the folded weights and the kernel wrapper's packed copy
        of them, so that the next forward folds the parameters anew.

        Needed after an in-place edit that no version counter records: a
        write through ``.data`` or ``.detach()``, or any edit of an
        inference tensor (parameters made or loaded under
        ``torch.inference_mode`` keep no version). ``load_state_dict``,
        ``.to()``, a training step and in-place edits of ordinary tensors
        are seen without it. For a whole model, call it on each
        ``Res2NetBlock`` in ``model.modules()``."""
        if self._folded is not None:
            invalidate_packed(self._folded[1][0])
        self._folded = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._use_fused(x):
            w, cb, s, b = self._folded[1] if self._frozen else self.folded()
            return res2net_cascade(x.contiguous(), w, cb, s, b,
                                   dilation=self.dilation)
        chunks = torch.chunk(x, self.scale, dim=1)
        outputs = [chunks[0]]
        y = None
        for i, blk in enumerate(self.blocks(), start=1):
            inp = chunks[i] if i == 1 else chunks[i] + y
            y = blk(inp)
            outputs.append(y)
        return torch.cat(outputs, dim=1)



@contextlib.contextmanager
def folded_constants(model: nn.Module) -> Iterator[None]:
    """Fold every ``Res2NetBlock``'s weights now, on the real parameters,
    and inside the block hand the kernel those tensors as they are: no
    storage or version check. ``torch.export`` traces fake parameters,
    which have neither, and takes the folded weights in as constants of
    the exported program (the fold of the weights the model holds now)."""
    blocks = [m for m in model.modules() if isinstance(m, Res2NetBlock)]
    for blk in blocks:
        blk.folded()
        blk._frozen = True
    try:
        yield
    finally:
        for blk in blocks:
            blk._frozen = False


class SEBlock(nn.Module):
    """Squeeze-and-excitation."""

    def __init__(self, in_channels: int, se_channels: int, out_channels: int):
        super().__init__()
        self.Conv1d_0 = Conv1d(in_channels, se_channels, 1)
        self.Conv1d_1 = Conv1d(se_channels, out_channels, 1)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is not None:
            mask = length_to_mask(lengths * x.shape[2], x.shape[2])[:, None, :]
            s = (x * mask).sum(dim=2, keepdim=True) / mask.sum(dim=2, keepdim=True)
        else:
            s = x.mean(dim=2, keepdim=True)                 # [B, C, 1]
        s = torch.relu(self.Conv1d_0(s))
        s = torch.sigmoid(self.Conv1d_1(s))
        return s * x


class AttentiveStatisticsPooling(nn.Module):
    """Channel-wise attentive mean∥std pooling with global context:
    ``[B, C, L] -> [B, 2C]``.

    With global context the attention TDNN's 1×1 conv over
    ``[x ∥ mean ∥ std]`` is split by input rows: the mean and std terms
    are L-independent, so only ``x`` goes through the conv (the same
    algebra as the JAX package)."""

    def __init__(self, channels: int, attention_channels: int = 128,
                 global_context: bool = True, eps: float = 1e-12):
        super().__init__()
        self.global_context, self.eps = global_context, eps
        in_ch = 3 * channels if global_context else channels
        self.TDNNBlock_0 = TDNNBlock(in_ch, attention_channels, 1,
                                     activation=torch.relu)
        self.Conv1d_0 = Conv1d(attention_channels, channels, 1)

    def _statistics(self, x, m):
        mean = (m * x).sum(dim=2)
        var = (m * (x - mean[:, :, None]) ** 2).sum(dim=2)
        return mean, torch.sqrt(torch.clamp(var, min=self.eps))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C, L = x.shape
        if lengths is None:
            lengths = torch.ones(B, dtype=x.dtype, device=x.device)
        # an fp32 mask, as the JAX module's: with bf16 activations the
        # statistics, and all that follows them, are fp32
        mask = length_to_mask(lengths * L, L)[:, None, :]       # [B,1,L]
        blk = self.TDNNBlock_0
        if self.global_context:
            total = mask.sum(dim=2, keepdim=True)
            mean, std = self._statistics(x, mask / total)
            conv = blk.Conv1d_0.Conv_0
            w = conv.weight[:, :, 0].to(mean.dtype)         # [A, 3C]
            ctx = (mean @ w[:, C:2 * C].T + std @ w[:, 2 * C:].T
                   + conv.bias.to(mean.dtype))
            # x's rows in the promoted type of x and the weights, as flax
            # promotes (a bf16 conv over an fp32 input is fp32)
            dt = torch.promote_types(x.dtype, conv.weight.dtype)
            h = F.conv1d(x.to(dt), conv.weight[:, :C].to(dt)) \
                + ctx[:, :, None]
            attn = blk.BatchNorm1d_0(torch.relu(h))
        else:
            attn = blk(x)
        attn = self.Conv1d_0(torch.tanh(attn))
        attn = attn.masked_fill(mask == 0, float("-inf"))
        attn = torch.softmax(attn, dim=2)
        mean, std = self._statistics(x, attn)
        return torch.cat([mean, std], dim=1)                # [B, 2C]


class SERes2NetBlock(nn.Module):
    """TDNN → Res2Net → TDNN → SE with a residual shortcut (a 1×1 conv
    when the width changes)."""

    def __init__(self, in_channels: int, features: int,
                 res2net_scale: int = 8, se_channels: int = 128,
                 kernel_size: int = 1, dilation: int = 1,
                 activation: Callable = gelu_exact, conv_backend: str = "xla"):
        super().__init__()
        if in_channels != features:
            self.Conv1d_0 = Conv1d(in_channels, features, 1)
        self.TDNNBlock_0 = TDNNBlock(in_channels, features, 1,
                                     activation=activation)
        # the inner Res2Net does not take the outer activation
        self.Res2NetBlock_0 = Res2NetBlock(features, res2net_scale,
                                           kernel_size, dilation,
                                           backend=conv_backend)
        self.TDNNBlock_1 = TDNNBlock(features, features, 1,
                                     activation=activation)
        self.SEBlock_0 = SEBlock(features, se_channels, features)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = self.Conv1d_0(x) if hasattr(self, "Conv1d_0") else x
        x = self.TDNNBlock_0(x)
        x = self.Res2NetBlock_0(x)
        x = self.TDNNBlock_1(x)
        x = self.SEBlock_0(x, lengths)
        return x + residual
