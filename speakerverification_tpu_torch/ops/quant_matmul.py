"""Static-scale int8 GEMM kernel (``csrc/quant_matmul.cu``) and its wrapper.

Port of ``speakerverification_tpu/ops/pallas_quant.py``. Weights are
quantized per output channel outside the kernel (:func:`quantize_weight`,
once per layer); the kernel quantizes the activations with the static
scale from calibration, multiplies in int8 with int32 sums and applies
``acc * (s_w * s_x) + bias``, stored in the input's dtype (fp32 or bf16).

Two layouts: a channels-first conv input ``[B, K, T]`` gives
``[B, N, T]`` (the kernel reads the port's activations as they are, with
no transposed copy), and a Dense input ``[M, K]`` gives ``[M, N]``.

:func:`quant_matmul` launches the kernel for a CUDA tensor and runs
:func:`quant_matmul_plain` for a CPU tensor. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

__all__ = ["quant_matmul", "quant_matmul_plain", "quantize_weight",
           "quantize_act", "per_channel_int8", "act_scales", "build",
           "launches"]

launches = 0
_launches_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "quant_matmul_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                             ctypes.c_float, _I, _I, _P], ctypes.c_int),
}


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    # a divisor held as a tensor on the operand's device: PyTorch's CUDA
    # division by a host scalar multiplies by its reciprocal instead
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def per_channel_int8(wf: torch.Tensor, dim):
    """Symmetric int8 of ``wf`` (fp32) with one scale per slice reduced
    over ``dim`` (an int or a tuple): ``s = max(max|w| / 127, 1e-12)``,
    ``q = clip(round(w / s))``, by division, as the JAX package quantizes
    weights and dynamic activations. Returns the integer values (fp32)
    and the scales (``dim`` kept)."""
    s = torch.clamp(wf.abs().amax(dim=dim, keepdim=True) / _f32(127.0, wf),
                    min=1e-12)
    return torch.clamp(torch.round(wf / s), -127, 127), s


def quantize_weight(w2d: torch.Tensor):
    """``w2d [N, K]`` float → ``(wq [N, K] int8, s_w [N] fp32)`` on
    ``w2d``'s device (``pallas_quant.py:64-66``, per output channel)."""
    q, s = per_channel_int8(w2d.detach().float(), dim=1)
    return q.to(torch.int8).contiguous(), s[:, 0].contiguous()


def act_scales(act_scale: float) -> tuple[float, float]:
    """``(s_x, inv_sx)``: ``s_x = max(act_scale / 127, 1e-12)`` in double
    precision and ``inv_sx = fp32(1 / s_x)``, as the TPU kernel's wrapper
    makes them."""
    s_x = max(float(act_scale) / 127.0, 1e-12)
    return s_x, float(np.float32(1.0 / s_x))


def quantize_act(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """``clip(rint(x * inv_sx), -127, 127)`` as int8 (the kernel's first
    step)."""
    _, inv_sx = act_scales(act_scale)
    return torch.clamp(torch.round(x.float() * inv_sx), -127, 127).to(torch.int8)


def _epilogue(wq, s_w, bias, act_scale):
    s_x, _ = act_scales(act_scale)
    dev = wq.device
    # fp32(s_x) as a host scalar: exact in the fp32 multiply, and no
    # host-to-device copy per call
    scale = s_w.to(dev, torch.float32) * float(np.float32(s_x))
    b = (torch.zeros(wq.shape[0], dtype=torch.float32, device=dev)
         if bias is None else bias.to(dev, torch.float32))
    return scale.contiguous(), b.contiguous()


def _check(x: torch.Tensor, wq: torch.Tensor):
    if x.dim() not in (2, 3):
        raise ValueError(f"quant_matmul takes [M, K] or [B, K, T], got "
                         f"{tuple(x.shape)}")
    if wq.dim() != 2 or wq.shape[1] != x.shape[1]:
        raise ValueError(f"weights {tuple(wq.shape)} do not match x "
                         f"{tuple(x.shape)} (K is x's dim 1)")
    if wq.dtype != torch.int8:
        raise ValueError(f"quantized weights must be int8, got {wq.dtype}")


def quant_matmul_plain(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                       bias, act_scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same rounding
    points. The integer product is taken in float64, which is exact for
    these K (|acc| <= 127² K < 2^53)."""
    _check(x, wq)
    scale, b = _epilogue(wq, s_w, bias, act_scale)
    xq = quantize_act(x, act_scale).double()
    if x.dim() == 3:
        acc = torch.matmul(wq.double(), xq)                # [B, N, T]
        out = acc.float() * scale[:, None] + b[:, None]
    else:
        acc = xq @ wq.double().T                            # [M, N]
        out = acc.float() * scale + b
    return out.to(x.dtype)


def build():
    """Build (if needed) and load the kernel's library."""
    from speakerverification_tpu_torch.ops._build import load
    return load("quant_matmul", _SIGNATURES)


def _launch(x, wq, s_w, bias, act_scale):
    global launches
    _check(x, wq)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_matmul kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if not (x.is_contiguous() and wq.is_contiguous()):
        raise ValueError("quant_matmul kernel needs contiguous x and wq")
    if wq.device != x.device or wq.data_ptr() % 16:
        raise ValueError("quantized weights must lie 16-byte aligned on "
                         "x's device")
    lib = build()
    scale, b = _epilogue(wq, s_w, bias, act_scale)
    _, inv_sx = act_scales(act_scale)
    channels_first = x.dim() == 3
    nb, K = (x.shape[0], x.shape[1]) if channels_first else (1, x.shape[1])
    ncols = x.shape[2] if channels_first else x.shape[0]
    N = wq.shape[0]
    out = torch.empty(((nb, N, ncols) if channels_first else (ncols, N)),
                      dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_launch(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
        out.data_ptr(), nb, K, N, ncols, inv_sx,
        int(x.dtype == torch.bfloat16), int(channels_first), stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"cudaError {err}")
    with _launches_lock:
        launches += 1
    return out


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                 bias, act_scale: float) -> torch.Tensor:
    """int8 product of ``x`` with the quantized weights ``wq [N, K]``.

    ``x`` is ``[B, K, T]`` (channels-first conv columns) → ``[B, N, T]``,
    or ``[M, K]`` → ``[M, N]``, in x's dtype. ``s_w [N]``: the weights'
    per-channel scales; ``bias [N]`` or None; ``act_scale``: the
    calibrated max-abs of x (a Python float).

    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version. There is no fallback between the two."""
    if x.is_cuda:
        return _launch(x, wq, s_w, bias, act_scale)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, wq, s_w, bias, act_scale)
    raise ValueError(f"quant_matmul: unsupported device {x.device}")
