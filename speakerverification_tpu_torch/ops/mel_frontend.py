"""Mel frontend kernel (``csrc/mel_frontend.cu``), its wrapper and pipeline.

Port of ``speakerverification_tpu/ops/pallas_frontend.py``. As there,
pre-emphasis and the reflect pad of ``n_fft/2`` run outside the kernel,
in PyTorch. The kernel does the rest: the overlapped frame gather (the
TPU kernel left that to an XLA gather), the windowed real DFT, the
power spectrum and the mel projection, at fp32 accuracy on the TF32
tensor cores: every product is three TF32 products of operands split
into ``hi + lo`` (:func:`tf32_split`). For a window symmetric about
``n_fft/2`` the DFT is folded about it (:func:`fold_basis`), which
halves its depth; any other window (an odd ``win_length``) takes the
unfolded route of the same kernel, the window's full depth, chosen by
the window's shape (:func:`symmetric`). The (folded) basis and the mel
bank are split once here and packed in the order the tensor-core
instructions read them (:func:`pack_constants`, :func:`chunk_stream`).

:func:`mel_frontend` calls the registered operator
``torch.ops.speakerverification_tpu_torch.mel_frontend``, which launches
the kernel for a CUDA tensor and runs :func:`mel_frontend_plain`, the
same function in plain PyTorch, for a CPU tensor. The operator has a
fake implementation (shapes, and the kernel's checks on a CUDA tensor),
so that ``torch.export`` traces through it, and a FLOP formula for
``FlopCounterMode`` that counts the plain frontend's work (the full
``n_fft`` DFT and the mel product), whatever computes it.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula
from torch.utils.weak import WeakIdKeyDictionary

from speakerverification_tpu_torch.ops.frontend import (
    FrontendConfig,
    mel_constants,
    pre_emphasis,
    reflect_pad,
    window_rows,
)

__all__ = ["make_mel_frontend", "mel_frontend", "mel_frontend_plain",
           "mel_frontend_flops", "symmetric", "launches", "MAX_MELS"]

launches = 0
_launches_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mel_frontend_launch": ([_P, _P, _P, _P] + [_I] * 9 + [_P],
                            ctypes.c_int),
    "mel_frontend_max_mels": ([], ctypes.c_int),
    "mel_frontend_bins_per_block": ([], ctypes.c_int),
    "mel_frontend_chunk_floats": ([], ctypes.c_int),
}
MAX_MELS = 128         # the kernel's mel_frontend_max_mels()
MMA_DEPTH = 8          # rows of one m16n8k8 step
SPAN_SKEW = 4          # the kernel's SKEW: empty span slots per hop samples


def _rows(n_fft: int, rows) -> tuple[int, int]:
    lo, hi = rows
    if not 0 <= lo < hi <= n_fft:
        raise ValueError(f"basis rows {rows} outside [0, {n_fft})")
    return lo, hi


def fold_rows(n_fft: int, rows, folded: bool = True) -> tuple[int, int, int]:
    """The kernel's geometry for the window rows ``[lo, hi)``: each frame's
    span is its samples ``[lo, hi)``, folded about ``c = n_fft/2`` into
    ``count`` rows ``d = 0 .. count-1`` (``x[c+d]`` with ``x[c-d]``), a
    multiple of the mma depth; unfolded, row ``d`` is sample ``lo + d``.
    Returns ``(lo, hi - lo, count)``."""
    lo, hi = _rows(n_fft, rows)
    if not folded:
        return lo, hi - lo, -(-(hi - lo) // MMA_DEPTH) * MMA_DEPTH
    c = n_fft // 2
    if not lo <= c < hi:
        raise ValueError(f"window rows {rows} do not hold n_fft/2 = {c}")
    d_max = max(hi - 1 - c, c - lo)
    return lo, hi - lo, -(-(d_max + 1) // MMA_DEPTH) * MMA_DEPTH


def _fold_geometry(cs: torch.Tensor, rows):
    n_fft, two_k = cs.shape
    lo, span, count = fold_rows(n_fft, rows)
    hi, c = lo + span, n_fft // 2
    d = torch.arange(count, device=cs.device)
    plus, minus = c + d, c - d
    mp = plus < hi
    mm = (minus >= lo) & (d > 0)
    return plus, minus, mp, mm


def _asymmetry(cs: torch.Tensor, rows) -> float:
    """How far the basis is from symmetric about ``c = n_fft/2`` over the
    window rows, relative to its largest entry (0 for a centred even
    window; inf where the rows do not hold ``c``)."""
    n_fft, two_k = cs.shape
    K = two_k // 2
    lo, hi = _rows(n_fft, rows)
    if not lo <= n_fft // 2 < hi:
        return float("inf")
    plus, minus, mp, mm = _fold_geometry(cs, rows)
    cos, sin = cs[:, :K], cs[:, K:]
    take_p, take_m = plus.clamp(max=n_fft - 1), minus.clamp(min=0)
    both = (mp & mm)[:, None]
    err = torch.maximum(((cos[take_p] - cos[take_m]).abs() * both).max(),
                        ((sin[take_p] + sin[take_m]).abs() * both).max())
    return float(err / cs.abs().max())


def symmetric(cs: torch.Tensor, rows) -> bool:
    """Whether the kernel may fold this basis: its window is symmetric
    about ``n_fft/2`` (every even ``win_length`` centred in the frame;
    an odd one is symmetric about ``n_fft/2 - 1/2`` and is not). The
    wrapper takes the folded route where this holds, the unfolded one
    elsewhere."""
    return _asymmetry(cs, rows) <= 1e-6


def fold_basis(cs: torch.Tensor, rows,
               folded: bool = True) -> tuple[torch.Tensor, ...]:
    """The basis folded about ``c = n_fft/2``: for ``d >= 0``,
    ``u_d = mp_d x[c+d] + mm_d x[c-d]`` times ``P[d]`` gives the cos
    products and ``v_d = mp_d x[c+d] - mm_d x[c-d]`` times ``Q[d]`` the sin
    products, up to the sign ``(-1)^k`` that the power drops. The masks
    ``mp``, ``mm`` are 1 where that side lies in the window rows. Needs a
    window symmetric about ``c`` (:func:`symmetric`).

    Unfolded (``folded=False``, any window): row ``d`` is sample
    ``lo + d`` with ``mp = 1``, ``mm = 0``, ``P = cos``, ``Q = sin``, so
    that ``u = v = x`` and the kernel takes the plain DFT over the
    window's rows. Returns ``(P, Q, mp, mm)``, ``P, Q [count, K]``."""
    n_fft, two_k = cs.shape
    K = two_k // 2
    cos, sin = cs[:, :K], cs[:, K:]
    if not folded:
        lo, span, count = fold_rows(n_fft, rows, folded=False)
        d = torch.arange(count, device=cs.device)
        mp = d < span
        take = (lo + d).clamp(max=n_fft - 1)
        zero = torch.zeros_like(cos[:1])
        P = torch.where(mp[:, None], cos[take], zero)
        Q = torch.where(mp[:, None], sin[take], zero)
        return P, Q, mp.float(), torch.zeros_like(mp, dtype=torch.float32)
    if _asymmetry(cs, rows) > 1e-6:
        raise ValueError("the kernel folds the DFT about n_fft/2: the "
                         "window must be symmetric about it")
    plus, minus, mp, mm = _fold_geometry(cs, rows)
    take_p, take_m = plus.clamp(max=n_fft - 1), minus.clamp(min=0)
    zero = torch.zeros_like(cos[:1])
    P = torch.where(mp[:, None], cos[take_p],
                    torch.where(mm[:, None], cos[take_m], zero))
    Q = torch.where(mp[:, None], sin[take_p],
                    torch.where(mm[:, None], -sin[take_m], zero))
    return P, Q, mp.float(), mm.float()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x ~ hi + lo`` with both TF32: the operands of a 3xTF32 product."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mma_fragments(b: torch.Tensor) -> torch.Tensor:
    """``b [8 * KS, 8 * NT]`` as m16n8k8 B fragments ``[KS, NT, 32, 4]``:
    lane ``4 g + t`` of k-step ``s``, n-tile ``j`` holds
    ``{hi, hi, lo, lo}`` of ``b[8 s + t, 8 j + g]`` and
    ``b[8 s + t + 4, 8 j + g]``."""
    k, n = b.shape
    v = b.reshape(k // 8, 2, 4, n // 8, 8).permute(0, 3, 4, 2, 1)
    hi, lo = tf32_split(v.reshape(k // 8, n // 8, 32, 2))
    return torch.cat([hi, lo], -1).contiguous()


def pack_constants(cs: torch.Tensor, fb: torch.Tensor, rows, nb: int,
                   folded: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's constants, split into TF32 ``hi + lo``.

    The (folded) basis (:func:`fold_basis`) of bins ``0 .. K-2``, in column
    blocks of ``nb`` bins (zero-padded), as ``[ncb, nkc, chunk]``: per
    block ``nkc`` chunks of 16 folded rows (zero-padded), each
    ``[k-step 2][P, Q][hi, lo][tile]``, a tile the 8 rows x ``nb``
    columns of one wgmma B operand: K-major core matrices of 8 columns x
    4 rows (16 bytes a column), ``[column group][row half][column][row]``.

    The mel bank as m16n8k8 B fragments ``[ncb * (nb / 8 + 1),
    ceil(n_mels / 8), 32, 4]``: per column block its ``nb`` bins' rows,
    then 8 rows led by the Nyquist bin ``K-1``'s in block 0, zero
    elsewhere. (The Nyquist bin's P is summed apart, in fp32.)"""
    n_fft = cs.shape[0]
    K, n_mels = fb.shape
    if n_fft != 2 * (K - 1):
        raise ValueError(f"the kernel takes the Nyquist bin apart: needs "
                         f"K = n_fft/2 + 1, got {K} bins at n_fft {n_fft}")
    P, Q, _, _ = fold_basis(cs, rows, folded)
    count = P.shape[0]
    nkc = -(-count // 16)
    ncb = -(-(K - 1) // nb)
    pad = ncb * nb - (K - 1)
    basis = torch.stack([F.pad(m[:, :K - 1], (0, pad, 0, 16 * nkc - count))
                         for m in (P, Q)], 1)
    # rows (chunk, k-step, half, row), columns (block, group, column)
    basis = basis.reshape(nkc, 2, 2, 4, 2, ncb, nb // 8, 8)
    basis = basis.permute(5, 0, 1, 4, 6, 2, 7, 3)
    tiles = torch.stack(tf32_split(basis.contiguous()), 4)
    mels = F.pad(fb[:K - 1], (0, -n_mels % 8, 0, pad)).reshape(ncb, nb, -1)
    nyquist = torch.zeros_like(mels[:, :8])
    nyquist[0, 0, :n_mels] = fb[K - 1]
    mels = torch.cat([mels, nyquist], 1).reshape(ncb * (nb + 8), -1)
    return tiles.reshape(ncb, nkc, -1).contiguous(), mma_fragments(mels)


def fold_table(cs: torch.Tensor, rows, hop: int,
               folded: bool = True) -> torch.Tensor:
    """Per folded row ``d``: the span columns of ``x[c+d]`` and ``x[c-d]``
    (relative to a row's first sample ``lo``, with ``SPAN_SKEW`` empty
    slots after every ``hop`` samples, as the kernel stores the span; a
    masked side points at ``x[c]``), the masks
    ``mp``, ``mm``, and the Nyquist bin's folded basis value:
    ``[count, 5]`` fp32. Unfolded, row ``d`` points at ``x[lo + d]`` (a
    padding row, and the masked side, at ``x[lo]``)."""
    n_fft = cs.shape[0]
    lo, _, count = fold_rows(n_fft, rows, folded)
    P, _, mp, mm = fold_basis(cs, rows, folded)
    d = torch.arange(count, device=cs.device)
    if folded:
        c = n_fft // 2
        plus = torch.where(mp > 0, c + d, c) - lo
        minus = torch.where(mm > 0, c - d, c) - lo
    else:
        plus = torch.where(mp > 0, d, 0)
        minus = torch.zeros_like(d)
    col = lambda i: (i + SPAN_SKEW * (i // hop)).float()  # noqa: E731
    return torch.stack([col(plus), col(minus), mp, mm, P[:, -1]], 1) \
        .contiguous()


def chunk_stream(basis: torch.Tensor, mfrag: torch.Tensor) -> torch.Tensor:
    """The kernel's one stream of constant chunks ``[ncb, nkc + nmc,
    chunk]``: per column block its basis chunks, then its rows of the mel
    bank cut into chunks of the same size (``kpm`` whole k-steps each,
    zero-padded)."""
    ncb, _, chunk = basis.shape
    steps, nmt = mfrag.shape[0] // ncb, mfrag.shape[1]
    kpm = chunk // (nmt * 32 * 4)
    nmc = -(-steps // kpm)
    mels = F.pad(mfrag.reshape(ncb, steps, -1), (0, 0, 0, nmc * kpm - steps))
    mels = F.pad(mels.reshape(ncb, nmc, -1), (0, chunk - kpm * nmt * 128))
    return torch.cat([basis, mels], 1).contiguous()


# per basis tensor (an entry lives as long as it does): the mel bank and
# the geometry it was packed for, the route, the constant chunks and the
# fold table
_packed = WeakIdKeyDictionary()


def _constants(cs, fb, rows, nb, hop):
    """``(folded, chunks, fold table)``: the route is chosen here, once
    per basis, by the window's shape."""
    key = (tuple(rows), nb, hop, cs.device)
    hit = _packed.get(cs)
    if hit is None or hit[0] is not fb or hit[1] != key:
        folded = symmetric(cs, rows)
        hit = _packed[cs] = (
            fb, key, folded,
            chunk_stream(*pack_constants(cs, fb, rows, nb, folded)),
            fold_table(cs, rows, hop, folded))
    return hit[2:]


def mel_frontend_plain(padded: torch.Tensor, cs: torch.Tensor,
                       fb: torch.Tensor, hop: int,
                       rows: tuple[int, int]) -> torch.Tensor:
    """``padded [B, Tp] -> mel [B, 1 + (Tp - n_fft)//hop, n_mels]``.

    ``rows = (lo, hi)``: the basis rows that may be nonzero (the
    window's, :func:`~speakerverification_tpu_torch.ops.frontend.window_rows`);
    the product skips the others."""
    n_fft, two_k = cs.shape
    lo, hi = _rows(n_fft, rows)
    frames = padded.unfold(-1, n_fft, hop)[..., lo:hi]    # [B, F, hi - lo]
    proj = frames @ cs[lo:hi]                             # [B, F, 2K]
    re, im = proj[..., :two_k // 2], proj[..., two_k // 2:]
    return (re * re + im * im) @ fb


def _launch(padded: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
            hop: int, rows) -> torch.Tensor:
    """The launch, in the CUDA context of ``padded``'s device (a process
    that drives several cards may have another one current)."""
    with torch.cuda.device(padded.device):
        return _launch_here(padded, cs, fb, hop, rows)


def _launch_here(padded: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
                 hop: int, rows) -> torch.Tensor:
    global launches
    from speakerverification_tpu_torch.ops._build import load
    lib = load("mel_frontend", _SIGNATURES)
    F_ = _check(padded, cs, fb, hop, rows, kernel=True)
    if lib.mel_frontend_max_mels() != MAX_MELS:
        raise ValueError(f"the kernel takes {lib.mel_frontend_max_mels()} "
                         f"mels, the wrapper checks {MAX_MELS}")
    for name, t in (("wave", padded), ("basis", cs), ("mel bank", fb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Tp = padded.shape
    n_fft = cs.shape[0]
    n_mels = fb.shape[1]
    folded, chunks, fold = _constants(
        cs, fb, rows, lib.mel_frontend_bins_per_block(), hop)
    lo, span, count = fold_rows(n_fft, rows, folded)
    if chunks.shape[-1] != lib.mel_frontend_chunk_floats():
        raise ValueError(f"chunks of {chunks.shape[-1]} floats, the kernel "
                         f"takes {lib.mel_frontend_chunk_floats()}")
    out = torch.empty((B, F_, n_mels), dtype=torch.float32,
                      device=padded.device)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    err = lib.mel_frontend_launch(
        padded.data_ptr(), chunks.data_ptr(), fold.data_ptr(), out.data_ptr(),
        B, Tp, lo, span, count, hop, F_, n_mels, chunks.shape[0],
        stream)
    if err != 0:
        raise RuntimeError(f"mel_frontend kernel launch failed: "
                           f"cudaError {err}")
    with _launches_lock:
        launches += 1
    return out


def refuse_grad(padded: torch.Tensor) -> None:
    """The kernel has no backward: a wave that needs a gradient raises
    ``ValueError`` instead of getting features with no gradient path.
    (A train step takes the gradient with respect to the parameters
    only, and the wave is not one.)"""
    if padded.requires_grad and torch.is_grad_enabled():
        raise ValueError("mel_frontend: the kernel has no backward, and "
                         "this wave requires a gradient")


def _check(padded, cs, fb, hop: int, rows, kernel: bool) -> int:
    """The checks made before any work, on shapes and dtypes alone (so
    on fake tensors too); ``kernel`` adds those of the CUDA kernel.
    Returns the frame count."""
    B, Tp = padded.shape
    n_fft, two_k = cs.shape
    K, n_mels = fb.shape
    if two_k != 2 * K:
        raise ValueError(f"basis has {two_k} columns, expected 2*{K}")
    _rows(n_fft, rows)
    if Tp < n_fft:
        raise ValueError(f"padded wave of {Tp} samples < n_fft {n_fft}")
    if kernel:
        if n_mels > MAX_MELS:
            raise ValueError(f"n_mels {n_mels} > {MAX_MELS}")
        if n_fft != 2 * (K - 1):
            raise ValueError(f"the kernel takes the Nyquist bin apart: "
                             f"needs K = n_fft/2 + 1, got {K} bins at "
                             f"n_fft {n_fft}")
        for name, t in (("wave", padded), ("basis", cs), ("mel bank", fb)):
            if t.dtype != torch.float32 or t.device != padded.device:
                raise ValueError(f"{name} must be float32 on "
                                 f"{padded.device}")
    return 1 + (Tp - n_fft) // hop


@torch.library.custom_op("speakerverification_tpu_torch::mel_frontend",
                         mutates_args=(), device_types="cpu")
def _mel_frontend_op(padded: torch.Tensor, cs: torch.Tensor,
                     fb: torch.Tensor, hop: int, lo: int,
                     hi: int) -> torch.Tensor:
    _check(padded, cs, fb, hop, (lo, hi), kernel=False)
    return mel_frontend_plain(padded, cs, fb, hop, (lo, hi))


@_mel_frontend_op.register_kernel("cuda")
def _(padded, cs, fb, hop, lo, hi):
    return _launch(padded, cs, fb, hop, (lo, hi))


@_mel_frontend_op.register_fake
def _(padded, cs, fb, hop, lo, hi):
    frames = _check(padded, cs, fb, hop, (lo, hi),
                    kernel=padded.device.type == "cuda")
    dtype = torch.promote_types(torch.promote_types(padded.dtype, cs.dtype),
                                fb.dtype)
    return padded.new_empty((padded.shape[0], frames, fb.shape[1]),
                            dtype=dtype)


@register_flop_formula(torch.ops.speakerverification_tpu_torch.mel_frontend)
def mel_frontend_flops(padded_shape, cs_shape, fb_shape, hop, lo, hi, *,
                       out_shape=None, **kwargs) -> int:
    """The plain frontend's products: frames ``[B, F, n_fft]`` @ the
    basis ``[n_fft, 2K]``, then the power ``[B, F, K]`` @ the mel bank
    (``2 B F n_fft 2K + 2 B F K n_mels``), whatever the kernel folds or
    skips."""
    B, frames, n_mels = out_shape
    n_fft, two_k = cs_shape
    return 2 * B * frames * (n_fft * two_k + two_k // 2 * n_mels)


def mel_frontend(padded: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
                 hop: int, rows: tuple[int, int]) -> torch.Tensor:
    """Frame, DFT, power and mel of a padded wave ``[B, Tp]``.

    ``rows = (lo, hi)``: the basis rows that may be nonzero; the others
    must be zero. Runs the registered operator on either device: CUDA
    tensors launch the hand-written kernel, CPU tensors run the plain
    version. There is no fallback between the two. The operator has no
    backward: a CPU call that needs a gradient runs the plain version
    directly, and a CUDA wave that requires one raises
    (:func:`refuse_grad`).

    On a CUDA tensor the kernel needs ``K = n_fft/2 + 1`` bins and at most
    128 mels, and raises ``ValueError`` on anything else (under
    ``torch.export`` too, from the fake implementation). It folds the
    DFT about ``n_fft/2`` where the window is symmetric about it (every
    even ``win_length`` centred in the frame) and takes the unfolded
    route, twice the depth, for any other window (an odd one, such as
    201 at 8 kHz or 441 at 22.05 kHz, is symmetric about
    ``n_fft/2 - 1/2``). The plain version on a CPU tensor takes any
    basis."""
    if padded.is_cuda:
        refuse_grad(padded)
    elif padded.device.type != "cpu":
        raise ValueError(f"mel_frontend: unsupported device {padded.device}")
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (padded, cs, fb)):
        return mel_frontend_plain(padded, cs, fb, hop, rows)
    lo, hi = rows
    return torch.ops.speakerverification_tpu_torch.mel_frontend(
        padded, cs, fb, hop, lo, hi)


def make_mel_frontend(cfg: FrontendConfig = FrontendConfig()):
    """Build ``wave [B, T] -> mel [B, 1 + T//hop, n_mels]`` around the
    kernel (counterpart of ``make_pallas_mel_frontend``)."""

    def frontend(wave: torch.Tensor) -> torch.Tensor:
        batch_shape = wave.shape[:-1]
        wave = wave.reshape(-1, wave.shape[-1]).to(torch.float32)
        if cfg.pre_emphasis is not None:
            wave = pre_emphasis(wave, cfg.pre_emphasis)
        padded = reflect_pad(wave, cfg.n_fft // 2).contiguous()
        cs, fb = mel_constants(cfg, padded.device)
        out = mel_frontend(padded, cs, fb, cfg.hop_length, window_rows(cfg))
        return out.reshape(batch_shape + out.shape[-2:])

    return frontend
