"""Res2Net cascade kernel (``csrc/res2net_cascade.cu``), eval mode.

Port of ``speakerverification_tpu/ops/pallas_res2net.py``. The whole
cascade of an SE-Res2Net block runs in one launch: group 0 passes
through; for ``i = 1..s-1``

    inp = chunk_i (+ y_{i-1})
    h   = sum_k shift(inp, (k-1)*d) @ W_k       # 3 taps, reflect halo
    y_i = relu(h + bias) * bn_scale + bn_shift  # BN folded by the caller

with fp32 accumulation, stored in x's dtype (fp32 or bf16). Unlike the
JAX package, the port keeps activations channels-first, so ``x`` is
``[B, s*H, T]``; the weights keep the JAX layout ``[s-1, 3, H, H]``
(tap, in, out).

The kernel takes its products on the tensor cores (fp32: three TF32
products of operands split into ``hi + lo``; bf16: one bf16 product)
and tiles time across blocks: a block owns a tile of output rows of one
batch row and computes group ``i`` over the tile widened by
``(s-1-i)*d`` rows per side (:func:`group_windows`), so blocks exchange
nothing. :func:`tile_schedule` splits T evenly and writes each block's
windows into the table the kernel reads; :func:`pack_weights` lays the
weights out in the order the tensor-core instructions read them, once
per weights tensor.

:func:`res2net_cascade` calls the registered operator
``torch.ops.speakerverification_tpu_torch.res2net_cascade``, which
launches the kernel for a CUDA tensor and runs
:func:`res2net_cascade_plain` for a CPU tensor. Its fake implementation
makes the kernel's checks on a CUDA tensor, so that ``torch.export``
refuses at export what the kernel could not take, and its FLOP formula
counts the plain convolutions' work. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula
from torch.utils.weak import WeakIdKeyDictionary

from speakerverification_tpu_torch.ops.mel_frontend import tf32_split

__all__ = ["res2net_cascade", "res2net_cascade_plain", "res2net_cascade_flops",
           "KERNEL_HIDDEN",
           "group_windows", "tile_schedule", "pack_weights", "state_version",
           "invalidate_packed",
           "launches"]

launches = 0
_launches_lock = threading.Lock()

# hidden widths (channels per group) the kernel library is built for
KERNEL_HIDDEN = (64, 128)
MAX_COLS = 128     # the kernel's MAX_COLS: the widest group window
CHUNK_CHANNELS = 64  # its Traits::KC: input channels per weight chunk

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "res2net_cascade_launch": ([_P] * 7 + [_I] * 7 + [_P], ctypes.c_int),
    "res2net_cascade_max_cols": ([], ctypes.c_int),
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and loaded once, its window width held
    against the schedule's."""
    from speakerverification_tpu_torch.ops._build import load
    lib = load("res2net_cascade", _SIGNATURES)
    if lib.res2net_cascade_max_cols() != MAX_COLS:
        raise ValueError(f"the kernel's windows hold "
                         f"{lib.res2net_cascade_max_cols()} rows, the "
                         f"schedule assumes {MAX_COLS}")
    return lib


def _check(x: torch.Tensor, weights: torch.Tensor, dilation: int):
    B, C, T = x.shape
    g1, k, hidden, hidden_out = weights.shape
    if k != 3 or hidden != hidden_out or C != (g1 + 1) * hidden:
        raise ValueError(f"cascade weights {tuple(weights.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if T <= 2 * dilation:
        raise ValueError(f"crop of {T} frames too short for the reflect "
                         f"halo of dilation {dilation}")
    return B, C, T, g1 + 1, hidden


def res2net_cascade_plain(x: torch.Tensor, weights: torch.Tensor,
                          conv_bias: torch.Tensor, bn_scale: torch.Tensor,
                          bn_shift: torch.Tensor, dilation: int) -> torch.Tensor:
    """The cascade in plain PyTorch: same rounding points as the kernel
    (inputs and weights in x's dtype, products summed in fp32)."""
    _, _, _, groups, hidden = _check(x, weights, dilation)
    w = weights.to(x.dtype).float().permute(0, 3, 2, 1)   # [g-1, out, in, k]
    chunks = x.split(hidden, dim=1)
    outs = [chunks[0]]
    y = None
    for i in range(1, groups):
        inp = chunks[i] if i == 1 else chunks[i] + y
        h = F.conv1d(F.pad(inp.float(), (dilation, dilation), mode="reflect"),
                     w[i - 1], dilation=dilation)
        h = torch.relu(h + conv_bias[i - 1].float()[:, None])
        y = (h * bn_scale[i - 1].float()[:, None]
             + bn_shift[i - 1].float()[:, None]).to(x.dtype)
        outs.append(y)
    return torch.cat(outs, dim=1)


def group_windows(o0: int, o1: int, T: int, groups: int,
                  dilation: int) -> list[tuple[int, int]]:
    """The rows ``[lo, hi)`` that group ``i`` computes for a block that
    owns the output rows ``[o0, o1)``: the tile widened by
    ``(groups-1-i) * dilation`` per side, cut to ``[0, T)``. Entry 0 is
    the span of x the block loads (group 1's input), the last entry the
    tile itself."""
    return [(max(0, o0 - (groups - 1 - i) * dilation),
             min(T, o1 + (groups - 1 - i) * dilation))
            for i in range(groups)]


def _tiles(T: int, n: int) -> list[tuple[int, int]]:
    return [(j * T // n, (j + 1) * T // n) for j in range(n)]


def _widest(T: int, n: int, groups: int, dilation: int) -> int:
    """The widest window a group computes (group 1's) over ``n`` tiles."""
    return max(hi - lo for lo, hi in
               (group_windows(o0, o1, T, groups, dilation)[1]
                for o0, o1 in _tiles(T, n)))


def _check_halo(T: int, groups: int, dilation: int) -> None:
    halo = 2 * max(groups - 2, 0) * dilation
    if T > MAX_COLS and 1 + halo > MAX_COLS:
        raise ValueError(f"dilation {dilation} too wide for the cascade "
                         f"kernel's windows of {MAX_COLS} rows at "
                         f"{groups} groups and a crop of {T} frames")


def tile_count(B: int, T: int, groups: int, dilation: int,
               slots: int) -> int:
    """Tiles per batch row: the fewest whose windows fit ``MAX_COLS``,
    or up to 4 more where that finishes sooner on ``slots`` concurrent
    blocks (waves of blocks times the column tiles of the busiest
    block). ``chip_smoke.py`` times 2 to 5 tiles at ECAPA_TDNN's
    shape beside this pick."""
    _check_halo(T, groups, dilation)
    n = -(-T // MAX_COLS)
    while _widest(T, n, groups, dilation) > MAX_COLS:
        n += 1

    def cost(n):
        work = max(sum(-(-(hi - lo) // 8) for lo, hi in
                       group_windows(o0, o1, T, groups, dilation)[1:])
                   for o0, o1 in _tiles(T, n))
        return -(-B * n // slots) * work

    return min(range(n, min(n + 5, T + 1)), key=cost)


def tile_schedule(B: int, T: int, groups: int, dilation: int,
                  slots: int) -> tuple[torch.Tensor, int]:
    """The kernel's blocks: ``table [B * n, 1 + 2 * groups]`` int32, per
    block its batch row and the windows ``lo, hi`` of groups ``0 ..
    groups-1`` (:func:`group_windows`, tiles of an even split of T, batch
    row major), and ``R``, the row stride of the block's input buffer in
    32-bit words: at least every span, 8 (mod 32) so that the rows of an
    mma fragment fall on distinct banks."""
    n = tile_count(B, T, groups, dilation, slots)
    rows, span = [], 0
    for b in range(B):
        for o0, o1 in _tiles(T, n):
            win = group_windows(o0, o1, T, groups, dilation)
            span = max(span, win[0][1] - win[0][0])
            rows.append([b] + [v for w in win for v in w])
    stride = -(-(span - 8) // 32) * 32 + 8
    return torch.tensor(rows, dtype=torch.int32), stride


def pack_weights(weights: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``weights [s-1, 3, H, H]`` (tap, in, out) rounded to ``dtype`` and
    laid out as the kernel streams them: per group and tap, chunks of
    ``CHUNK_CHANNELS`` input channels, each the mma A fragments of
    ``W_k^T`` (rows = output channels) of its k-steps:

    - float32: ``[k-step 8][m-tile H/16][hi, lo][lane 32][4]`` fp32, the
      m16n8k8 tf32 fragment ``{a0..a3}`` of lane ``4 g + t``: rows
      ``g, g + 8`` by columns ``t, t + 4`` (:func:`tf32_split`);
    - bfloat16: ``[k-step 4][m-tile][lane 32][4]`` words of two bf16, the
      m16n8k16 fragment: rows ``g, g + 8`` by columns ``2t, 2t + 1`` and
      ``2t + 8, 2t + 9``.

    Returns ``[(s-1) * 3 * H / CHUNK_CHANNELS, words per chunk]`` (fp32
    or int32)."""
    G, _, H, _ = weights.shape
    a = weights.detach().to(dtype).permute(0, 1, 3, 2)    # [G, 3, out, in]
    mt, cc = H // 16, H // CHUNK_CHANNELS
    if dtype == torch.float32:
        # out = (mt, hh, g), in = (cc, ks, hk, t); a_r at r = hh + 2 hk
        v = a.float().reshape(G, 3, mt, 2, 8, cc, CHUNK_CHANNELS // 8, 2, 4)
        v = v.permute(0, 1, 5, 6, 2, 4, 8, 7, 3).reshape(
            G, 3, cc, CHUNK_CHANNELS // 8, mt, 32, 4)
        hi, lo = tf32_split(v.contiguous())
        return torch.stack([hi, lo], 5).reshape(G * 3 * cc, -1)
    if dtype == torch.bfloat16:
        # in = (cc, ks, hk, t, p): p, the half of a word
        v = a.reshape(G, 3, mt, 2, 8, cc, CHUNK_CHANNELS // 16, 2, 4, 2)
        v = v.permute(0, 1, 5, 6, 2, 4, 8, 7, 3, 9).contiguous()
        return v.view(torch.int32).reshape(G * 3 * cc, -1)
    raise ValueError(f"cascade kernel takes float32 or bfloat16, got {dtype}")


# per weights tensor (an entry lives as long as it does), per (dtype,
# device): its version and storage, and the packed weights
_packed = WeakIdKeyDictionary()


def state_version(t: torch.Tensor) -> int:
    """``t``'s version counter (bumped by every in-place write); -1 for an
    inference tensor, which keeps none."""
    return -1 if t.is_inference() else t._version


def invalidate_packed(weights: torch.Tensor) -> None:
    """Forget the packed copy of ``weights`` that the wrapper keeps, so
    that the next launch packs it anew. Needed after an in-place edit
    that no version counter records: a write through ``.data`` or
    ``.detach()``, or any edit of an inference tensor (which keeps no
    version). In-place edits of ordinary tensors are seen without it."""
    _packed.pop(weights, None)


def _packed_weights(weights, dtype, device):
    """The packed copy of ``weights`` for ``dtype`` on ``device``; one
    copy per device, so replicas on several cards never share one."""
    per_device = _packed.get(weights)
    if per_device is None:
        per_device = _packed[weights] = {}
    key = (state_version(weights), weights.data_ptr())
    hit = per_device.get((dtype, device))
    if hit is None or hit[0] != key:
        hit = per_device[(dtype, device)] = (
            key, pack_weights(weights.to(device), dtype).contiguous())
    return hit[1]


@functools.lru_cache(maxsize=64)
def _schedule(B, T, groups, dilation, device):
    slots = torch.cuda.get_device_properties(device).multi_processor_count
    table, stride = tile_schedule(B, T, groups, dilation, slots)
    return table.to(device), stride


def _launch(x, weights, conv_bias, bn_scale, bn_shift, dilation):
    """The launch, in the CUDA context of ``x``'s device (a process that
    drives several cards may have another one current)."""
    with torch.cuda.device(x.device):
        return _launch_here(x, weights, conv_bias, bn_scale, bn_shift,
                            dilation)


def _launch_here(x, weights, conv_bias, bn_scale, bn_shift, dilation):
    global launches
    B, C, T, groups, hidden = _check_kernel(x, weights, dilation)
    if not x.is_contiguous():
        raise ValueError("cascade kernel needs a contiguous [B, C, T] input")
    lib = _library()
    dev = x.device
    table, stride = _schedule(B, T, groups, dilation, dev)
    w = _packed_weights(weights, x.dtype, dev)
    cb, s, t = (v.to(device=dev, dtype=torch.float32).contiguous()
                for v in (conv_bias, bn_scale, bn_shift))
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.res2net_cascade_launch(
        x.data_ptr(), w.data_ptr(), table.data_ptr(), cb.data_ptr(),
        s.data_ptr(), t.data_ptr(), out.data_ptr(), table.shape[0], T,
        hidden, groups, dilation, stride, int(x.dtype == torch.bfloat16),
        stream)
    if err != 0:
        raise RuntimeError(f"res2net_cascade kernel launch failed: "
                           f"cudaError {err}")
    with _launches_lock:
        launches += 1
    return out


def _check_kernel(x, weights, dilation):
    """The kernel's own checks, on shapes and dtypes alone (so on fake
    tensors too); returns ``_check``'s ``(B, C, T, groups, hidden)``."""
    shape = _check(x, weights, dilation)
    T, groups, hidden = shape[2:]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cascade kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"cascade kernel is built for hidden widths "
                         f"{KERNEL_HIDDEN}, got {hidden}")
    _check_halo(T, groups, dilation)
    return shape


@torch.library.custom_op("speakerverification_tpu_torch::res2net_cascade",
                         mutates_args=(), device_types="cpu")
def _res2net_cascade_op(x: torch.Tensor, weights: torch.Tensor,
                        conv_bias: torch.Tensor, bn_scale: torch.Tensor,
                        bn_shift: torch.Tensor,
                        dilation: int) -> torch.Tensor:
    return res2net_cascade_plain(x, weights, conv_bias, bn_scale, bn_shift,
                                 dilation)


@_res2net_cascade_op.register_kernel("cuda")
def _(x, weights, conv_bias, bn_scale, bn_shift, dilation):
    return _launch(x, weights, conv_bias, bn_scale, bn_shift, dilation)


@_res2net_cascade_op.register_fake
def _(x, weights, conv_bias, bn_scale, bn_shift, dilation):
    if x.device.type == "cuda":
        _check_kernel(x, weights, dilation)
    else:
        _check(x, weights, dilation)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.speakerverification_tpu_torch.res2net_cascade)
def res2net_cascade_flops(x_shape, w_shape, *args, out_shape=None,
                          **kwargs) -> int:
    """The plain cascade's convolutions: ``2 B T H^2 3 (s-1)``."""
    B, _, T = x_shape
    g1, k, hidden, _ = w_shape
    return 2 * B * T * hidden * hidden * k * g1


def res2net_cascade(x: torch.Tensor, weights: torch.Tensor,
                    conv_bias: torch.Tensor, bn_scale: torch.Tensor,
                    bn_shift: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """Run the eval-mode Res2Net cascade on ``x [B, s*H, T]``.

    Args:
      weights: ``[s-1, 3, H, H]`` conv kernels (tap, in, out).
      conv_bias, bn_scale, bn_shift: ``[s-1, H]``; eval BatchNorm folded
        to ``y = h * bn_scale + bn_shift``.
      dilation: conv dilation (kernel size is 3).

    Runs the registered operator on either device: CUDA tensors launch
    the hand-written kernel, CPU tensors run the plain version. There is
    no fallback between the two. The operator has no backward: a CPU
    call that needs a gradient runs the plain version directly. On a
    CUDA tensor a group's window must fit the kernel's 128 rows: past
    128 frames that takes ``1 + 2 (s-2) dilation <= 128`` (dilation 10
    at s = 8), and the kernel raises ``ValueError`` on a wider halo
    (under ``torch.export`` too, from the fake implementation). The
    packed weights are kept per ``weights`` tensor until its storage or
    version changes or it dies; after an edit that keeps both, call
    :func:`invalidate_packed`."""
    args = (x, weights, conv_bias, bn_scale, bn_shift)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"res2net_cascade: unsupported device {x.device}")
    if not x.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in args):
        return res2net_cascade_plain(*args, dilation)
    return torch.ops.speakerverification_tpu_torch.res2net_cascade(
        *args, dilation)
