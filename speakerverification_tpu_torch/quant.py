"""Post-training int8 embedding extraction (port of ``quant.py``).

Every large ``nn.Conv1d``/``nn.Linear`` GEMM of a model copy runs as
quantize → int8 product with int32 sums → dequantize; small layers
(below the :class:`QuantConfig` floors), strided and grouped convs keep
their float path. Weights are quantized per output channel once, when
the copy is built; activations take one per-tensor scale, either
calibrated beforehand (static mode, :func:`calibrate_act_scales`, the
serving configuration) or reduced from each input (dynamic mode).

Where the JAX package intercepts flax method calls, the port swaps the
quantizable modules of a deep copy for :class:`QuantConv1d` and
:class:`QuantLinear`. Calibration records the inputs of modules that are
*called*, as the flax interceptor does, so a weight read directly (the
attention conv of ECAPA's pooling, ``models/layers.py``) stays float.

Static-scale layers go through ``ops/quant_matmul.py`` (the K3 kernel on
CUDA, its plain version on the CPU); dynamic-scale layers through
:func:`_int8_gemm`, which divides by the activation scale where the
kernel multiplies by its inverse, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.ops.quant_matmul import (
    per_channel_int8,
    quant_matmul,
    quantize_weight,
)
from speakerverification_tpu_torch.weights import cast_copy

__all__ = ["QuantConfig", "QuantConv1d", "QuantLinear", "quantizable",
           "check_calibratable", "quantize_model", "calibrate_act_scales",
           "int8_apply", "make_int8_embed_fn"]

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Which GEMMs go int8.

    A layer is quantized only when its contraction dim ``K`` (kernel taps
    × in-channels for convs) is at least ``min_k`` and its output dim
    at least ``min_n``."""
    min_k: int = 512
    min_n: int = 128
    quant_conv: bool = True
    quant_dense: bool = True


def _int8_gemm(x2d: torch.Tensor, w2d: torch.Tensor,
               act_scale: Optional[float] = None) -> torch.Tensor:
    """``[M, K] @ [K, N]`` via symmetric int8 with exact integer sums.

    Activations: one per-tensor scale, the max-abs of ``x2d`` (dynamic)
    or ``act_scale`` (static); weights: one scale per output channel.
    Both quantize by division. Returns fp32 ``[M, N]`` (no bias)."""
    xf = x2d.float()
    if act_scale is None:
        xq, s_x = per_channel_int8(xf, dim=(0, 1))      # one scale: s_x [1, 1]
    else:
        s_x = torch.tensor(max(act_scale / 127.0, 1e-12), dtype=torch.float32,
                           device=xf.device)
        xq = torch.clamp(torch.round(xf / s_x), -127, 127)
    wq, s_w = per_channel_int8(w2d.float(), dim=0)      # s_w [1, N]
    acc = (xq.double() @ wq.double()).float()
    return acc * (s_x * s_w)


def _conv_padding(m: nn.Conv1d) -> tuple[int, int]:
    total = m.dilation[0] * (m.kernel_size[0] - 1)
    if m.padding == "valid":
        return 0, 0
    if m.padding == "same":
        return total // 2, total - total // 2
    return m.padding[0], m.padding[0]


def quantizable(m: nn.Module, config: QuantConfig) -> bool:
    """Whether ``m`` is a GEMM the config quantizes: a plain
    ``nn.Linear`` or a stride-1, ungrouped, zero-padded ``nn.Conv1d``
    whose ``K`` and ``N`` clear the floors."""
    if type(m) is nn.Linear:
        return (config.quant_dense and m.in_features >= config.min_k
                and m.out_features >= config.min_n)
    if type(m) is nn.Conv1d:
        return (config.quant_conv and m.stride == (1,) and m.groups == 1
                and m.padding_mode == "zeros"
                and m.kernel_size[0] * m.in_channels >= config.min_k
                and m.out_channels >= config.min_n)
    return False


def _called_quantizable(m: nn.Module, x: torch.Tensor,
                        config: QuantConfig) -> bool:
    # the JAX predicates also look at the call's input: a Dense on
    # ndim >= 2, a conv on a batched [B, C, T] input
    if type(m) is nn.Linear:
        return quantizable(m, config) and x.dim() >= 2
    return quantizable(m, config) and x.dim() == 3


def _key(name: str) -> str:
    """Module name → the flax path the JAX package keys scales by."""
    return name.replace(".", "/")


class _QuantGemm(nn.Module):
    """Shared state of the int8 modules: the (possibly cast) float
    weight and bias, which stay readable as ``weight``/``bias``, and the
    int8 weights ``wq [N, K]`` with their scales ``s_w [N]``, quantized
    once from ``w_nk``, the weight as the kernel's ``[N, K]`` rows."""

    def __init__(self, weight: nn.Parameter, bias, w_nk: torch.Tensor,
                 act_scale: Optional[float]):
        super().__init__()
        self.weight, self.bias, self.act_scale = weight, bias, act_scale
        wq, s_w = quantize_weight(w_nk)
        self.register_buffer("wq", wq)
        self.register_buffer("s_w", s_w)

    def w_kn(self) -> torch.Tensor:
        """The float weight as ``_int8_gemm``'s ``[K, N]`` (dynamic mode)."""
        raise NotImplementedError

    def gemm(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[M, K]`` or ``[B, K, T]`` → ``[M, N]`` or ``[B, N, T]``
        in x's dtype."""
        if self.act_scale is not None:
            return quant_matmul(x, self.wq, self.s_w, self.bias,
                                self.act_scale)
        rows = x if x.dim() == 2 else x.transpose(1, 2).reshape(-1, x.shape[1])
        y = _int8_gemm(rows, self.w_kn(), self.act_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        if x.dim() == 3:
            y = y.reshape(x.shape[0], x.shape[2], -1).transpose(1, 2)
        return y.to(x.dtype)


class QuantLinear(_QuantGemm):
    def __init__(self, m: nn.Linear, act_scale: Optional[float]):
        super().__init__(m.weight, m.bias, m.weight, act_scale)

    def w_kn(self) -> torch.Tensor:
        return self.weight.T

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() < 2:
            return F.linear(x, self.weight, self.bias)
        y = self.gemm(x.reshape(-1, x.shape[-1]).contiguous())
        return y.reshape(*x.shape[:-1], -1)


class QuantConv1d(_QuantGemm):
    """A stride-1 ``nn.Conv1d`` as im2col + int8 GEMM. The columns are
    tap-major (``i * Cin + c``), matching the JAX package's
    ``kernel.reshape(k * Cin, Cout)``; at the default floors every live
    layer is k = 1 and the GEMM reads the input as it is."""

    def __init__(self, m: nn.Conv1d, act_scale: Optional[float]):
        # weight [out, in, k] -> [out, k * in] (tap-major columns)
        super().__init__(m.weight, m.bias,
                         m.weight.permute(0, 2, 1).reshape(m.out_channels, -1),
                         act_scale)
        self.k, self.d = m.kernel_size[0], m.dilation[0]
        self.pad, self.float_padding = _conv_padding(m), m.padding

    def w_kn(self) -> torch.Tensor:
        return self.weight.permute(2, 1, 0).reshape(-1, self.weight.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3:
            return F.conv1d(x, self.weight, self.bias, dilation=self.d,
                            padding=self.float_padding)
        if any(self.pad):
            x = F.pad(x, self.pad)
        t_out = x.shape[2] - self.d * (self.k - 1)
        cols = x if self.k == 1 else torch.cat(
            [x[:, :, i * self.d:i * self.d + t_out] for i in range(self.k)],
            dim=1)
        return self.gemm(cols.contiguous())


def check_calibratable(model: nn.Module,
                       config: Optional[QuantConfig] = None) -> None:
    """Raise ``NotImplementedError`` when ``model`` holds a GRU with a
    layer that ``config`` quantizes. The JAX package cannot calibrate such
    a model: its recorder reads ``float(jnp.max(...))`` of the layer's
    input, which inside ``nn.RNN``'s scan is traced, so static int8 (and
    ``quant: int8``) of the RawNet2 GRU models fails there. The port keeps
    that limit; dynamic int8 (no ``act_scales``) works in both."""
    from speakerverification_tpu_torch.models.recurrent import GRUCell
    cfg = config or QuantConfig()
    grus = sorted(_key(n) for n, m in model.named_modules()
                  if isinstance(m, GRUCell)
                  and any(quantizable(c, cfg) for c in m.children()))
    if grus:
        raise NotImplementedError(
            f"static int8 calibration of the GRU ({', '.join(grus)}) is not "
            "ported: the JAX package cannot calibrate a layer inside "
            "nn.RNN's scan (its recorder reads a traced max), so quant: "
            "int8 of this model fails there too; dynamic int8 (int8_apply "
            "without act_scales) works")


def quantize_model(model: nn.Module, config: Optional[QuantConfig] = None,
                   act_scales: Optional[Mapping[str, float]] = None,
                   ) -> nn.Module:
    """Swap ``model``'s quantizable modules, in place, for int8 ones, and
    return the model (the int8 module itself when ``model`` is one
    quantizable layer, whose key is ``""``).

    With ``act_scales`` (static mode) exactly the modules named by its
    keys are swapped, each with its scale; a key that names no
    quantizable module raises ``KeyError``. Without (dynamic mode) every
    quantizable module is swapped."""
    cfg = config or QuantConfig()
    targets = {_key(n): (n, m) for n, m in model.named_modules()
               if quantizable(m, cfg)}
    if act_scales is not None:
        unknown = sorted(set(act_scales) - set(targets))
        if unknown:
            raise KeyError(f"act_scales name no quantizable module: "
                           f"{unknown[:5]}")
        targets = {k: v for k, v in targets.items() if k in act_scales}
    for key, (name, m) in targets.items():
        scale = None if act_scales is None else float(act_scales[key])
        kind = QuantLinear if type(m) is nn.Linear else QuantConv1d
        if not name:
            return kind(m, scale)
        parent_name, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent_name), child, kind(m, scale))
    return model


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, *args,
                         config: Optional[QuantConfig] = None,
                         margin: float = 1.1, **kwargs) -> dict:
    """Run the float ``model`` once in eval mode and return
    ``{flax path: max|input| * margin}`` for every quantizable module
    that is called. ``margin`` leaves headroom for later batches that
    run hotter than the calibration batch (static int8 saturates at
    ±127·scale). A model with a quantized GRU raises
    (:func:`check_calibratable`)."""
    cfg = config or QuantConfig()
    check_calibratable(model, cfg)
    scales: dict = {}

    def recorder(key):
        def hook(mod, inputs):
            x = inputs[0]
            if _called_quantizable(mod, x, cfg):
                m = float(x.detach().float().abs().max())
                scales[key] = max(scales.get(key, 0.0), m)
        return hook

    handles = [m.register_forward_pre_hook(recorder(_key(n)))
               for n, m in model.named_modules() if quantizable(m, cfg)]
    was_training = model.training
    model.eval()
    try:
        model(*args, **kwargs)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return {k: v * margin for k, v in scales.items()}


@torch.no_grad()
def int8_apply(model: nn.Module, *args, config: Optional[QuantConfig] = None,
               act_scales: Optional[Mapping[str, float]] = None, **kwargs):
    """``model(*args)`` with every large Conv/Dense GEMM in int8 (on a
    quantized copy; ``model`` is left as it is)."""
    qmodel = quantize_model(copy.deepcopy(model), config, act_scales)
    return qmodel.eval()(*args, **kwargs)


def make_int8_embed_fn(model: nn.Module, normalize: bool = True,
                       compute_dtype: Optional[torch.dtype] = None,
                       config: Optional[QuantConfig] = None,
                       act_scales: Optional[Mapping[str, float]] = None,
                       ) -> Callable:
    """Drop-in for ``inference.make_eval_embed_fn`` with int8 GEMMs:
    ``embed(wave [B, T]) -> [B, D]`` fp32 on the model's device. The
    parameters are cast to ``compute_dtype`` before the weights are
    quantized, as in the JAX package; pass ``act_scales`` for the
    static-scale serving mode."""
    # imported here: inference imports this module
    from speakerverification_tpu_torch.inference import make_eval_embed_fn
    qmodel = quantize_model(cast_copy(model, compute_dtype), config,
                            act_scales)
    return make_eval_embed_fn(qmodel, normalize=normalize)
