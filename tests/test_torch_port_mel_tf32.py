"""The mel kernel's arithmetic, rehearsed on the CPU.

K1 (``csrc/mel_frontend.cu``) folds the DFT about ``n_fft/2`` and takes
both of its products on the TF32 tensor cores. TF32 keeps 10 mantissa
bits, so each product is taken as three: operands split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, summed as
``hi*lo + lo*hi + hi*hi`` in fp32. These tests emulate that arithmetic
in torch on the constants exactly as the wrapper packs them for the
kernel (unpacked by the wgmma B-operand layout for the DFT and the
``mma.sync`` m16n8k8 fragment layout for the mel bank), and hold it
against the plain version at the kernel's tolerance,
``1e-5 * max|ref|``. A single TF32 product must fail that tolerance, so
the tolerance is shown to tell the two apart.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speakerverification_tpu_torch.ops import mel_frontend as mf
from speakerverification_tpu_torch.ops.frontend import (
    FrontendConfig,
    mel_constants,
    pre_emphasis,
    reflect_pad,
    window_rows,
)

CONFIGS = {
    "8k": FrontendConfig(),
    "16k": FrontendConfig(sample_rate=16000, win_length=400, hop_length=160,
                          fmin=20.0, fmax=7600.0),
}
NB = 64                 # the kernel's bins per column block
TOL = 1e-5


def _unpack(frags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B fragments ``[KS, NT, 32, 4]`` back to ``hi, lo [8 KS, 8 NT]`` by
    the PTX layout: lane ``l`` holds b0 at ``(k = l % 4, n = l // 4)``
    and b1 at ``(k = l % 4 + 4, n = l // 4)``."""
    ks, nt = frags.shape[:2]
    hi = torch.empty(8 * ks, 8 * nt)
    lo = torch.empty(8 * ks, 8 * nt)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for h in range(2):
            hi[t + 4 * h::8, g::8] = frags[:, :, lane, h]
            lo[t + 4 * h::8, g::8] = frags[:, :, lane, 2 + h]
    return hi, lo


def _unpack_tiles(basis: torch.Tensor):
    """The basis chunks ``[ncb, nkc, 4096]`` back to ``hi, lo [2, 16 nkc,
    64 ncb]`` (P, Q) by the wgmma B layout: per k-step, kind and hi/lo a
    tile of 8 rows x 64 columns, column n, row k at float
    ``(n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4``."""
    ncb, nkc = basis.shape[:2]
    out = torch.empty(2, 2, 16 * nkc, 64 * ncb)     # [hi/lo, P/Q, k, n]
    k, n = torch.meshgrid(torch.arange(8), torch.arange(64), indexing="ij")
    at = (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
    for cb in range(ncb):
        for kc in range(nkc):
            for ks in range(2):
                for kind in range(2):
                    for hl in range(2):
                        tile = basis[cb, kc, ((ks * 2 + kind) * 2 + hl) * 512:]
                        out[hl, kind, kc * 16 + ks * 8:kc * 16 + ks * 8 + 8,
                            cb * 64:cb * 64 + 64] = tile[at]
    return out[0], out[1]


def _product(a, b_hi, b_lo, passes):
    a_hi, a_lo = mf.tf32_split(a)
    if passes == 1:
        return a_hi @ b_hi
    # products of TF32 values are exact in fp32; the sums round in fp32
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _emulate(padded, cs, fb, hop, rows, passes, folded=True):
    """The kernel's arithmetic on its packed constants: the folded (or,
    on the unfolded route, plain) DFT (u @ P, v @ Q), power, the Nyquist
    bin's fp32 sum, the mel product."""
    n_fft = cs.shape[0]
    n_mels = fb.shape[1]
    lo, span, count = mf.fold_rows(n_fft, rows, folded)
    basis, mfrag = mf.pack_constants(cs, fb, rows, NB, folded)
    ncb, nkc = basis.shape[:2]
    b_hi, b_lo = _unpack_tiles(basis)                 # [P/Q, 16 nkc, 64 ncb]
    m_hi, m_lo = _unpack(mfrag)
    table = mf.fold_table(cs, rows, hop, folded)
    frames = padded.unfold(-1, n_fft, hop)[..., lo:lo + span]
    # a span column counts SPAN_SKEW empty slots after every hop samples
    col = table[:, :2].long()
    sample = col - mf.SPAN_SKEW * (col // (hop + mf.SPAN_SKEW))
    xp, xm = (frames[..., sample[:, i]] for i in (0, 1))
    mp, mm = table[:, 2], table[:, 3]
    u, v = mp * xp + mm * xm, mp * xp - mm * xm          # [B, F, count]
    pad = (0, 16 * nkc - count)
    P = _product(F.pad(u, pad), b_hi[0], b_lo[0], passes)
    Q = _product(F.pad(v, pad), b_hi[1], b_lo[1], passes)
    power = (P ** 2 + Q ** 2).reshape(*P.shape[:-1], ncb, NB)
    extra = torch.zeros(*power.shape[:-1], 8)       # the Nyquist k-step
    extra[..., 0, 0] = (u * table[:, 4]).sum(-1) ** 2
    power = torch.cat([power, extra], -1).flatten(-2)
    return _product(power, m_hi, m_lo, passes)[..., :n_mels]


def _inputs(cfg, amplitude, seed=0, n=5, seconds=1.0):
    rng = np.random.default_rng(seed)
    wave = amplitude * rng.standard_normal(
        (n, int(seconds * cfg.sample_rate))).astype(np.float32)
    padded = reflect_pad(pre_emphasis(torch.from_numpy(wave)),
                         cfg.n_fft // 2).contiguous()
    cs, fb = mel_constants(cfg, "cpu")
    return padded, cs, fb


def _rel_err(cfg, amplitude, passes, folded=True):
    padded, cs, fb = _inputs(cfg, amplitude)
    rows = window_rows(cfg)
    ref = mf.mel_frontend_plain(padded, cs, fb, cfg.hop_length, rows)
    got = _emulate(padded, cs, fb, cfg.hop_length, rows, passes, folded)
    assert got.shape == ref.shape
    return ((got - ref).abs().max() / ref.abs().max()).item()


def test_tf32_round_is_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11])
    want = torch.tensor([1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 ** -9])
    assert torch.equal(mf.tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    r = mf.tf32_round(y)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11).all()
    hi, lo = mf.tf32_split(y)
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("shape", [(16, 8), (32, 24), (8, 128)])
def test_mma_fragments_follow_the_ptx_layout(shape):
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        shape).astype(np.float32))
    hi, lo = _unpack(mf.mma_fragments(b))
    hi_want, lo_want = mf.tf32_split(b)
    assert torch.equal(hi, hi_want) and torch.equal(lo, lo_want)


@pytest.mark.parametrize("name,geometry", [("8k", (156, 200, 104)),
                                           ("16k", (56, 400, 208))])
def test_fold_rows_halve_the_window(name, geometry):
    cfg = CONFIGS[name]
    assert mf.fold_rows(cfg.n_fft, window_rows(cfg)) == geometry
    assert mf.fold_rows(512, (0, 512)) == (0, 512, 264)
    with pytest.raises(ValueError, match="n_fft/2"):
        mf.fold_rows(512, (300, 510))
    with pytest.raises(ValueError, match="outside"):
        mf.fold_rows(512, (10, 600))


@pytest.mark.parametrize("name", ["8k", "16k"])
def test_folded_basis_gives_the_dft_power(name):
    """(u @ P)^2 + (v @ Q)^2 = (frames @ C)^2 + (frames @ S)^2."""
    cfg = CONFIGS[name]
    cs, _ = mel_constants(cfg, "cpu")
    rows = window_rows(cfg)
    _, _, count = mf.fold_rows(cfg.n_fft, rows)
    P, Q, mp, mm = (m.double() for m in mf.fold_basis(cs, rows))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (7, cfg.n_fft)))
    c, d = cfg.n_fft // 2, torch.arange(count)
    xp = x[:, (c + d).clamp(max=cfg.n_fft - 1)]
    xm = x[:, (c - d).clamp(min=0)]
    got = ((mp * xp + mm * xm) @ P) ** 2 + ((mp * xp - mm * xm) @ Q) ** 2
    K = cs.shape[1] // 2
    full = x @ cs.double()
    want = full[:, :K] ** 2 + full[:, K:] ** 2
    torch.testing.assert_close(got, want, rtol=1e-9,
                               atol=1e-9 * want.max().item())


def test_packed_constants_hold_the_folded_basis_and_the_mel_bank():
    cfg = CONFIGS["8k"]
    cs, fb = mel_constants(cfg, "cpu")
    rows = window_rows(cfg)
    tiles, mfrag = mf.pack_constants(cs, fb, rows, NB)
    assert tiles.shape == (4, 7, 4096)   # 256 bins, 104 -> 112 rows
    assert mfrag.shape == (4 * 9, 10, 32, 4)
    hi, lo = _unpack_tiles(tiles)
    assert torch.equal(hi, mf.tf32_round(hi))
    basis = hi + lo                                   # [P/Q, 112, 256]
    P, Q, _, _ = mf.fold_basis(cs, rows)
    tol = dict(rtol=2 ** -21, atol=0)
    torch.testing.assert_close(basis[0, :104], P[:, :256], **tol)
    torch.testing.assert_close(basis[1, :104], Q[:, :256], **tol)
    assert (basis[:, 104:] == 0).all()
    m_hi, m_lo = _unpack(mfrag)
    mels = (m_hi + m_lo).reshape(4, 72, 80)
    torch.testing.assert_close(mels[:, :64].flatten(0, 1), fb[:256], **tol)
    torch.testing.assert_close(mels[0, 64], fb[256], **tol)
    assert (mels[0, 65:] == 0).all() and (mels[1:, 64:] == 0).all()


def test_fold_table_points_at_the_skewed_span():
    cs, _ = mel_constants(CONFIGS["8k"], "cpu")
    table = mf.fold_table(cs, window_rows(CONFIGS["8k"]), hop=80)
    assert table.shape == (104, 5)
    col = lambda i: i + 4 * (i // 80)  # noqa: E731
    # d = 0: x[256] once; d = 99: both sides; d = 100: x[156] only
    assert table[0, :4].tolist() == [col(100), col(100), 1.0, 0.0]
    assert table[99, :4].tolist() == [col(199), col(1), 1.0, 1.0]
    assert table[100, :4].tolist() == [col(100), col(0), 0.0, 1.0]
    assert (table[101:, 2:4] == 0).all()


@pytest.mark.parametrize("n_mels", [80, 40, 128])
def test_chunk_stream_puts_the_mel_bank_after_each_blocks_basis(n_mels):
    cfg = dataclasses.replace(CONFIGS["8k"], n_mels=n_mels)
    cs, fb = mel_constants(cfg, "cpu")
    tiles, mfrag = mf.pack_constants(cs, fb, window_rows(cfg), NB)
    stream = mf.chunk_stream(tiles, mfrag)
    nmt = -(-n_mels // 8)
    kpm = 32 // nmt                  # k-steps of the mel bank per chunk
    nmc = -(-9 // kpm)
    assert stream.shape == (4, 7 + nmc, 4096)
    assert torch.equal(stream[:, :7], tiles)
    mels = stream[:, 7:, :kpm * nmt * 128].reshape(4, nmc * kpm, nmt, 32, 4)
    assert torch.equal(mels[:, :9], mfrag.reshape(4, 9, nmt, 32, 4))
    assert (mels[:, 9:] == 0).all()
    assert (stream[:, 7:, kpm * nmt * 128:] == 0).all()


def test_packed_constants_reject_what_the_kernel_cannot_fold():
    """The Nyquist layout is refused on either route; a lopsided basis
    is refused by the fold, and the wrapper's route check sends it to
    the unfolded route, which packs it."""
    cs, fb = mel_constants(CONFIGS["8k"], "cpu")
    rows = window_rows(CONFIGS["8k"])
    with pytest.raises(ValueError, match="Nyquist"):
        mf.pack_constants(cs[:, 1:-1], fb[1:], rows, NB)
    with pytest.raises(ValueError, match="Nyquist"):
        mf.pack_constants(cs[:, 1:-1], fb[1:], rows, NB, folded=False)
    lopsided = cs.clone()
    lopsided[200] *= 1.01
    with pytest.raises(ValueError, match="symmetric"):
        mf.pack_constants(lopsided, fb, rows, NB)
    assert mf.symmetric(cs, rows) and not mf.symmetric(lopsided, rows)
    basis, _ = mf.pack_constants(lopsided, fb, rows, NB, folded=False)
    assert basis.shape[:2] == (4, 13)       # 200 rows: 13 chunks of 16


@pytest.mark.parametrize("amplitude", [0.1, 0.3])
@pytest.mark.parametrize("name", ["8k", "16k"])
def test_three_tf32_products_meet_the_fp32_tolerance(name, amplitude):
    assert _rel_err(CONFIGS[name], amplitude, passes=3) <= TOL


@pytest.mark.parametrize("amplitude", [0.1, 0.3])
@pytest.mark.parametrize("name", ["8k", "16k"])
def test_one_tf32_product_fails_the_tolerance(name, amplitude):
    assert _rel_err(CONFIGS[name], amplitude, passes=1) > 10 * TOL


@pytest.mark.parametrize("win_length", [441, 401])
def test_odd_windows_are_refused_by_the_kernels_fold(win_length):
    """A periodic window of odd length is symmetric about n_fft/2 - 1/2,
    not n_fft/2: the kernel's fold cannot take it, so its constants are
    refused by the fold, and the route check sends such a window to the
    unfolded route (the plain version takes it too)."""
    cfg = FrontendConfig(sample_rate=22050, win_length=win_length,
                         hop_length=220)
    cs, fb = mel_constants(cfg, "cpu")
    with pytest.raises(ValueError, match="symmetric"):
        mf.pack_constants(cs, fb, window_rows(cfg), NB)
    assert not mf.symmetric(cs, window_rows(cfg))
    assert mf.fold_rows(cfg.n_fft, window_rows(cfg), folded=False)[2] == \
        -(-win_length // 8) * 8
    padded, _, _ = _inputs(cfg, 0.1, n=2, seconds=0.1)
    out = mf.mel_frontend(padded, cs, fb, cfg.hop_length, window_rows(cfg))
    assert out.shape == (2, 11, cfg.n_mels) and torch.isfinite(out).all()


ODD = {
    "8k w201": FrontendConfig(win_length=201),
    "22k w441": FrontendConfig(sample_rate=22050, win_length=441,
                               hop_length=220),
}


@pytest.mark.parametrize("amplitude", [0.1, 0.3])
@pytest.mark.parametrize("name", sorted(ODD))
def test_unfolded_route_meets_the_fp32_tolerance(name, amplitude):
    """The unfolded route (odd windows): the kernel's arithmetic on its
    unfolded constants is within the kernel's tolerance, and one TF32
    pass is not."""
    assert _rel_err(ODD[name], amplitude, passes=3, folded=False) <= TOL
    assert _rel_err(ODD[name], amplitude, passes=1, folded=False) > 10 * TOL


@pytest.mark.parametrize("name", ["8k", "16k"])
def test_unfolded_route_takes_even_windows_too(name):
    """The unfolded constants give the DFT of any window: on an even one
    the two routes agree within the tolerance."""
    assert _rel_err(CONFIGS[name], 0.3, passes=3, folded=False) <= TOL
