"""Static-scale int8 GEMM kernel (``csrc/quant_matmul.cu``) and its wrapper.

Port of ``speakerverification_tpu/ops/pallas_quant.py``. Weights are
quantized per output channel outside the kernel (:func:`quantize_weight`,
once per layer); the kernel quantizes the activations with the static
scale from calibration, multiplies in int8 with int32 sums and applies
``acc * (s_w * s_x) + bias``, stored in the input's dtype (fp32 or bf16).

Two layouts: a channels-first conv input ``[B, K, T]`` gives
``[B, N, T]`` (the kernel reads the port's activations as they are, with
no transposed copy), and a Dense input ``[M, K]`` gives ``[M, N]``. The
library has one kernel per layout: int8 ``wgmma`` on channels-first
tiles, ``mma.sync`` on Dense rows; a conv input of one time step is a
Dense row (the same function in the other layout).

:func:`conv_grid` (the conv kernel's schedule) and
:func:`pack_conv_weights` (its weight tiles) are replayed in integers on
the CPU by ``tests/test_torch_port_quant_wgmma.py``, with a model of the
kernel's loads, stores and operand layout.

:func:`quant_matmul` launches the kernel for a CUDA tensor and runs
:func:`quant_matmul_plain` for a CPU tensor. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from speakerverification_tpu_torch.ops.res2net_cascade import state_version

__all__ = ["quant_matmul", "quant_matmul_plain", "quantize_weight",
           "quantize_act", "per_channel_int8", "act_scales", "build",
           "launches", "CONV_TILE", "conv_grid", "pack_conv_weights",
           "invalidate_packed", "quant_matmul_trace", "TRACE_FIELDS"]

launches = 0
_launches_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "quant_matmul_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                             ctypes.c_float, _I, _I, _P, _P], ctypes.c_int),
    "quant_matmul_conv_geometry": ([ctypes.POINTER(_I)], None),
}

# the conv kernel's block tile: output channels, time steps, reduction
# depth per stage (csrc CM, CN, CK; checked when the library loads)
CONV_TILE = (256, 128, 64)
# the conv kernel's trace, per block: thread 0's clock64 cycles in the
# prologue (until the first step is quantized), and within the steps in
# issuing the product and the barrier, issuing copies, waiting for
# copies, quantizing, waiting for the tensor cores, and the epilogues
TRACE_FIELDS = ("prologue", "product_barrier", "issue", "copy_wait",
                "quantize", "mma_wait", "epilogue")
RES_STEPS = 16       # csrc RES_STEPS: K <= 16 * 64 keeps x quantized
GRID_MAX = 65535     # a grid's y and z extents


def conv_grid(nb: int, N: int, K: int, T: int,
              sms: int = 132) -> tuple[tuple[int, int, int], int]:
    """The conv kernel's grid and output-channel tiles per block.

    A block covers one time tile of one batch row and ``tiles``
    consecutive output-channel tiles, over which it keeps its quantized x
    (so x is read and quantized once per ``tiles`` tiles, not once per
    tile). ``tiles`` is the largest of 4, 2 that divides the tile count
    and leaves at least three blocks per SM (``sms``), when K fits the
    kernel's kept steps; else 1. Returns ``((tile groups, time tiles,
    batch rows), tiles)``: tile groups vary fastest, so the blocks that
    read one x tile run next to one another."""
    cm, cn, ck = CONV_TILE
    n_tiles, t_tiles = -(-N // cm), -(-T // cn)
    tiles = 1
    if -(-K // ck) <= RES_STEPS:
        for g in (4, 2):
            if n_tiles % g == 0 and n_tiles // g * t_tiles * nb >= 3 * sms:
                tiles = g
                break
    return (n_tiles // tiles, t_tiles, nb), tiles


def pack_conv_weights(wq: torch.Tensor) -> torch.Tensor:
    """``wq [N, K]`` int8 as the conv kernel streams it: ``[N / CM][K /
    CK][CM * CK]`` (rounded up, zero past N and K), each tile in its
    shared-memory order, so that one bulk copy moves a step's tile:
    ``wgmma`` core matrices of 8 rows x 16 bytes of K, ``[row / 8][K
    chunk][row % 8][16 bytes]`` (csrc ``core_offset``)."""
    cm, _, ck = CONV_TILE
    N, K = wq.shape
    nt, ks = -(-N // cm), -(-K // ck)
    w = torch.zeros(nt * cm, ks * ck, dtype=torch.int8, device=wq.device)
    w[:N, :K] = wq
    # (tile, row group, row, step, k chunk, byte) -> (tile, step, row
    # group, k chunk, row, byte)
    w = w.view(nt, cm // 8, 8, ks, ck // 16, 16).permute(0, 3, 1, 4, 2, 5)
    return w.contiguous().view(nt, ks, cm * ck)


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
    """Build (if needed) and load the kernel's library; its conv tile
    must be ``CONV_TILE``."""
    from speakerverification_tpu_torch.ops._build import load
    lib = load("quant_matmul", _SIGNATURES)
    geom = (ctypes.c_int * 5)()
    lib.quant_matmul_conv_geometry(geom)
    want = CONV_TILE + (RES_STEPS, len(TRACE_FIELDS))
    if tuple(geom) != want:
        raise RuntimeError(f"quant_matmul library's conv geometry "
                           f"{tuple(geom)} is not {want}")
    return lib


# per int8 weights tensor (an entry lives as long as it does), per
# device: its version and storage, and the conv kernel's packed tiles
_packed = WeakIdKeyDictionary()


def invalidate_packed(wq: torch.Tensor) -> None:
    """Forget the packed tiles of ``wq`` that the wrapper keeps. Needed
    after an in-place edit that no version counter records: a write
    through ``.data`` or ``.detach()``, or any edit of an inference
    tensor. ``load_state_dict`` and in-place edits of ordinary tensors
    are seen without it."""
    _packed.pop(wq, None)


def _packed_weights(wq):
    """The conv kernel's tiles of ``wq``, one copy per device."""
    per_device = _packed.get(wq)
    if per_device is None:
        per_device = _packed[wq] = {}
    key = (state_version(wq), wq.data_ptr())
    hit = per_device.get(wq.device)
    if hit is None or hit[0] != key:
        hit = per_device[wq.device] = (key, pack_conv_weights(wq))
    return hit[1]


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x, wq, s_w, bias, act_scale, trace=None):
    """The launch, in the CUDA context of ``x``'s device (a process that
    drives several cards may have another one current)."""
    with torch.cuda.device(x.device):
        return _launch_here(x, wq, s_w, bias, act_scale, trace)


def _launch_here(x, wq, s_w, bias, act_scale, trace=None):
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
    N = wq.shape[0]
    out = torch.empty(((x.shape[0], N, x.shape[2]) if x.dim() == 3
                       else (x.shape[0], N)), dtype=x.dtype, device=x.device)
    # [B, K, 1] is [B, K] as Dense rows, and its out [B, N, 1] is [B, N]
    channels_first = x.dim() == 3 and x.shape[2] > 1
    nb, K = (x.shape[0], x.shape[1]) if channels_first else (1, x.shape[1])
    ncols = x.shape[2] if channels_first else x.shape[0]
    grid, tiles = (conv_grid(nb, N, K, ncols, _sms(x.device))
                   if channels_first else ((1, -(-ncols // 128), 1), 0))
    if max(grid[1:]) > GRID_MAX:
        raise ValueError(f"quant_matmul kernel takes at most {GRID_MAX} "
                         f"batch rows and {GRID_MAX} tiles of time steps or "
                         f"Dense rows; got x {tuple(x.shape)}")
    lib = build()
    scale, b = _epilogue(wq, s_w, bias, act_scale)
    _, inv_sx = act_scales(act_scale)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w = _packed_weights(wq) if channels_first else wq
    err = lib.quant_matmul_launch(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), b.data_ptr(),
        out.data_ptr(), nb, K, N, ncols, inv_sx,
        int(x.dtype == torch.bfloat16), tiles,
        None if trace is None else trace.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"cudaError {err}")
    with _launches_lock:
        launches += 1
    return out


def quant_matmul_trace(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                       bias, act_scale: float):
    """:func:`quant_matmul` of a channels-first CUDA ``x`` (T > 1) with the
    conv kernel's per-block timeline: returns ``(out, trace)``, ``trace``
    int64 ``[blocks, len(TRACE_FIELDS)]`` on the CPU, blocks in grid
    order (output-channel tiles fastest). For measurement only."""
    if not (x.is_cuda and x.dim() == 3 and x.shape[2] > 1):
        raise ValueError("quant_matmul_trace takes a channels-first CUDA x "
                         "with more than one time step")
    grid, _ = conv_grid(x.shape[0], wq.shape[0], x.shape[1], x.shape[2],
                        _sms(x.device))
    blocks = int(np.prod(grid))
    trace = torch.zeros(blocks, len(TRACE_FIELDS), dtype=torch.int64,
                        device=x.device)
    out = _launch(x, wq, s_w, bias, act_scale, trace)
    return out, trace.cpu()


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                 bias, act_scale: float) -> torch.Tensor:
    """int8 product of ``x`` with the quantized weights ``wq [N, K]``.

    ``x`` is ``[B, K, T]`` (channels-first conv columns) → ``[B, N, T]``,
    or ``[M, K]`` → ``[M, N]``, in x's dtype. ``s_w [N]``: the weights'
    per-channel scales; ``bias [N]`` or None; ``act_scale``: the
    calibrated max-abs of x (a Python float).

    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version. There is no fallback between the two. On CUDA, x must be
    contiguous (it may start at any element) and ``wq`` contiguous and
    16-byte aligned on x's device; the conv layout's packed tiles of
    ``wq`` are kept until its storage or version changes or it dies
    (after an edit that keeps both, call :func:`invalidate_packed`)."""
    if x.is_cuda:
        return _launch(x, wq, s_w, bias, act_scale)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, wq, s_w, bias, act_scale)
    raise ValueError(f"quant_matmul: unsupported device {x.device}")
