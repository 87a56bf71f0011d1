"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch only (no JAX), so it also runs on the GPU host:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

The ``cuda``-marked tests need a card and nvcc and skip without them;
the others check the wrappers' CPU contract here.

Tolerances: fp32 kernels 1e-5 of the output's largest magnitude (fp32
sums in another order). The int8 GEMM (K3) must match its plain version
bit for bit: its sums are exact integers and both round the epilogue's
multiply and add separately. bf16 cascade: the largest error within 2 bf16
ulps of max|ref| (a 1-ulp rounding flip passes, diluted, through the
later groups), and the mean error within 1e-4 of the mean |ref|
(reordering alone stays near 1e-5; a missing bf16 rounding of the
inter-group add gives 2e-3).
"""

import dataclasses

import pytest
import torch

from speakerverification_tpu_torch.ops import mel_frontend as mf
from speakerverification_tpu_torch.ops import quant_matmul as qm
from speakerverification_tpu_torch.ops import res2net_cascade as rc
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _bf16_close(got, ref):
    diff, ref = (got.float() - ref.float()).abs(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().max()))) / 128
    return bool(diff.max() <= 2 * ulp
                and diff.mean() <= 1e-4 * ref.abs().mean())


def _cascade_inputs(hidden, T, dtype, device, seed=0, B=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 8 * hidden, T, generator=g).to(dtype)
    w = torch.randn(7, 3, hidden, hidden, generator=g) / (3 * hidden) ** 0.5
    cb = 0.1 * torch.randn(7, hidden, generator=g)
    s = 0.5 + torch.rand(7, hidden, generator=g)
    sh = 0.1 * torch.randn(7, hidden, generator=g)
    return [v.to(device) for v in (x, w, cb, s, sh)]


# (config, utterances, samples, n_mels): the kernel tiles the flattened
# [B * F] frame rows by 64, so a tile may hold the end of one utterance
# and the start of the next, or several whole ones
MEL_CASES = [
    ("8k", 5, 8000, 80),      # F 101: a boundary inside a tile
    ("16k", 5, 16000, 80),
    ("8k", 5, 5127, 80),      # samples not a multiple of the hop
    ("8k", 1, 3000, 80),      # F 38: fewer rows than one tile
    ("8k", 7, 720, 80),       # F 10: seven utterances in one tile
    ("16k", 3, 1600, 80),     # F 11 at hop 160
    ("8k", 160, 16000, 80),   # the serving batch: 32,160 rows
    ("8k", 5, 8000, 40),      # other mel counts the wrapper takes
    ("16k", 5, 8000, 128),
]


def _mel_inputs(name, n, samples, n_mels, device):
    cfg = dataclasses.replace(CONFIGS[name], n_mels=n_mels)
    g = torch.Generator().manual_seed(samples + n)
    wave = (0.3 * torch.randn(n, samples, generator=g)).to(device)
    padded = reflect_pad(pre_emphasis(wave), cfg.n_fft // 2).contiguous()
    cs, fb = mel_constants(cfg, device)
    return cfg, padded, cs, fb


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,samples,n_mels", MEL_CASES)
def test_mel_kernel_matches_plain(cuda, name, n, samples, n_mels):
    cfg, padded, cs, fb = _mel_inputs(name, n, samples, n_mels, cuda)
    before = mf.launches
    got = mf.mel_frontend(padded, cs, fb, cfg.hop_length, window_rows(cfg))
    torch.cuda.synchronize()
    assert mf.launches == before + 1
    ref = mf.mel_frontend_plain(padded, cs, fb, cfg.hop_length,
                                (0, cfg.n_fft))
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= 1e-5


# odd windows take the kernel's unfolded route: (sample rate, win, hop,
# utterances, samples)
MEL_ODD_CASES = [
    (8000, 201, 80, 160, 16000),     # chip_smoke's shape
    (8000, 201, 80, 5, 5127),
    (22050, 441, 220, 3, 22050),
    (16000, 401, 160, 1, 3000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sr,win,hop,n,samples", MEL_ODD_CASES)
def test_mel_kernel_unfolded_route_matches_plain(cuda, sr, win, hop, n,
                                                 samples):
    cfg = FrontendConfig(sample_rate=sr, win_length=win, hop_length=hop)
    g = torch.Generator().manual_seed(samples + n)
    wave = (0.3 * torch.randn(n, samples, generator=g)).to(cuda)
    padded = reflect_pad(pre_emphasis(wave), cfg.n_fft // 2).contiguous()
    cs, fb = mel_constants(cfg, cuda)
    assert not mf.symmetric(cs, window_rows(cfg))
    before = mf.launches
    got = mf.mel_frontend(padded, cs, fb, cfg.hop_length, window_rows(cfg))
    torch.cuda.synchronize()
    assert mf.launches == before + 1
    ref = mf.mel_frontend_plain(padded, cs, fb, cfg.hop_length,
                                (0, cfg.n_fft))
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.cuda
def test_mel_kernel_rejects_too_many_mels(cuda):
    cfg, padded, cs, fb = _mel_inputs("8k", 2, 2000, 136, cuda)
    with pytest.raises(ValueError, match="n_mels"):
        mf.mel_frontend(padded, cs, fb, cfg.hop_length, window_rows(cfg))


def test_mel_kernel_refuses_a_wave_that_needs_a_gradient():
    """K1 has no backward: the check the CUDA path runs before a launch,
    exercised here on CPU tensors (a train step's wave needs no
    gradient, and passes)."""
    wave = torch.zeros(2, 600, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        mf.refuse_grad(wave)
    with torch.no_grad():
        mf.refuse_grad(wave)
    mf.refuse_grad(wave.detach())


@pytest.mark.cuda
def test_mel_kernel_raises_on_a_cuda_wave_that_needs_a_gradient(cuda):
    frontend = mf.make_mel_frontend(CONFIGS["8k"])
    wave = torch.zeros(2, 16000, device=cuda, requires_grad=True)
    before = mf.launches
    with pytest.raises(ValueError, match="no backward"):
        frontend(wave)
    assert mf.launches == before
    assert frontend(wave.detach()).shape == (2, 201, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,samples", [("8k", 5, 8000),
                                            ("16k", 3, 16000)])
def test_mel_op_passes_opcheck_and_equals_the_launch(cuda, name, n, samples):
    """The registered operator on CUDA tensors: ``opcheck`` (schema, fake
    implementation, autograd registration, AOT dispatch), and its output
    bit for bit a direct launch of the kernel's wrapper."""
    cfg, padded, cs, fb = _mel_inputs(name, n, samples, 80, cuda)
    lo, hi = window_rows(cfg)
    op = torch.ops.speakerverification_tpu_torch.mel_frontend
    result = torch.library.opcheck(op.default,
                                   (padded, cs, fb, cfg.hop_length, lo, hi))
    assert set(result.values()) == {"SUCCESS"}, result
    before = mf.launches
    got = op(padded, cs, fb, cfg.hop_length, lo, hi)
    assert mf.launches == before + 1
    assert torch.equal(got, mf._launch(padded, cs, fb, cfg.hop_length,
                                       (lo, hi)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,T", [(64, 201), (128, 300)])
def test_cascade_op_passes_opcheck_and_equals_the_launch(cuda, hidden, T,
                                                         dtype):
    x, w, cb, s, sh = _cascade_inputs(hidden, T, dtype, cuda)
    op = torch.ops.speakerverification_tpu_torch.res2net_cascade
    result = torch.library.opcheck(op.default, (x, w, cb, s, sh, 2))
    assert set(result.values()) == {"SUCCESS"}, result
    before = rc.launches
    got = op(x, w, cb, s, sh, 2)
    assert rc.launches == before + 1
    assert torch.equal(got, rc._launch(x, w, cb, s, sh, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("hidden", [64, 128])
def test_cascade_kernel_matches_plain(cuda, hidden, dilation, dtype):
    x, w, cb, s, sh = _cascade_inputs(hidden, 70 + dilation, dtype, cuda)
    before = rc.launches
    got = rc.res2net_cascade(x, w, cb, s, sh, dilation=dilation)
    torch.cuda.synchronize()
    assert rc.launches == before + 1
    ref = rc.res2net_cascade_plain(x, w, cb, s, sh, dilation)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert _rel_err(got, ref) <= 1e-5
    else:
        assert _bf16_close(got, ref)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_device_when_another_is_current(
        cuda):
    """K1 and K2 on tensors of ``cuda:1`` while ``cuda:0`` is current: the
    wrappers enter the tensors' device, so the kernels run there (a
    launch in the current context would fail or read another card's
    memory) and agree with their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev1 = torch.device("cuda", 1)
    cfg, padded, cs, fb = _mel_inputs("8k", 5, 8000, 80, dev1)
    x, w, cb, s, sh = _cascade_inputs(64, 201, torch.float32, dev1)
    with torch.cuda.device(0):
        mel = mf.mel_frontend(padded, cs, fb, cfg.hop_length,
                              window_rows(cfg))
        out = rc.res2net_cascade(x, w, cb, s, sh, dilation=2)
    torch.cuda.synchronize(dev1)
    assert mel.device == dev1 and out.device == dev1
    assert _rel_err(mel, mf.mel_frontend_plain(
        padded, cs, fb, cfg.hop_length, (0, cfg.n_fft))) <= 1e-5
    assert _rel_err(out, rc.res2net_cascade_plain(x, w, cb, s, sh, 2)) <= 1e-5


# (batch rows, crop) at the edges of the kernel's time tiles: the
# shortest crop (2d + 1), one window of MAX_COLS rows and one row either
# side of it (one tile, then two), path B's serving batch, a long crop,
# a single batch row
CASCADE_EDGES = [(3, "2d+1"), (3, rc.MAX_COLS - 1), (3, rc.MAX_COLS),
                 (3, rc.MAX_COLS + 1), (80, 201), (2, 1001), (1, 201)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("hidden", [64, 128])
@pytest.mark.parametrize("B,T", CASCADE_EDGES)
def test_cascade_kernel_tile_edges(cuda, B, T, hidden, dilation, dtype):
    T = 2 * dilation + 1 if T == "2d+1" else T
    x, w, cb, s, sh = _cascade_inputs(hidden, T, dtype, cuda, seed=T, B=B)
    before = rc.launches
    got = rc.res2net_cascade(x, w, cb, s, sh, dilation=dilation)
    torch.cuda.synchronize()
    assert rc.launches == before + 1
    ref = rc.res2net_cascade_plain(x, w, cb, s, sh, dilation)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert _rel_err(got, ref) <= 1e-5
    else:
        assert _bf16_close(got, ref)


@pytest.mark.cuda
def test_cascade_kernel_rejects_a_halo_wider_than_its_window(cuda):
    x, w, cb, s, sh = _cascade_inputs(64, 300, torch.float32, cuda)
    with pytest.raises(ValueError, match="too wide"):
        rc.res2net_cascade(x, w, cb, s, sh, dilation=11)


@pytest.mark.cuda
def test_cascade_kernel_rejects_unbuilt_width(cuda):
    x, w, cb, s, sh = _cascade_inputs(32, 20, torch.float32, cuda)
    with pytest.raises(ValueError, match="hidden widths"):
        rc.res2net_cascade(x, w, cb, s, sh, dilation=2)


def test_cpu_tensors_take_the_plain_versions():
    cfg = CONFIGS["8k"]
    padded = reflect_pad(torch.randn(2, 1000), cfg.n_fft // 2)
    cs, fb = mel_constants(cfg, "cpu")
    rows = window_rows(cfg)
    before = (mf.launches, rc.launches)
    torch.testing.assert_close(
        mf.mel_frontend(padded, cs, fb, cfg.hop_length, rows),
        mf.mel_frontend_plain(padded, cs, fb, cfg.hop_length, rows))
    args = _cascade_inputs(16, 12, torch.float32, "cpu")
    torch.testing.assert_close(rc.res2net_cascade(*args, dilation=2),
                               rc.res2net_cascade_plain(*args, 2))
    before_q = qm.launches
    qargs = _quant_inputs((2, 40, 9), 24, torch.float32, "cpu")
    assert torch.equal(qm.quant_matmul(*qargs), qm.quant_matmul_plain(*qargs))
    assert (mf.launches, rc.launches, qm.launches) == before + (before_q,)


@pytest.mark.parametrize("name", ["8k", "16k"])
def test_mel_window_rows_skip_only_zero_basis_rows(name):
    """The basis is zero outside ``window_rows``, so the product over the
    window's rows equals the full one."""
    cfg = CONFIGS[name]
    cs, fb = mel_constants(cfg, "cpu")
    lo, hi = window_rows(cfg)
    assert hi - lo == cfg.win_length
    assert not cs[:lo].any() and not cs[hi:].any() and cs[lo].any()
    padded = reflect_pad(torch.randn(2, 3000, generator=torch.Generator()
                                     .manual_seed(1)), cfg.n_fft // 2)
    torch.testing.assert_close(
        mf.mel_frontend(padded, cs, fb, cfg.hop_length, (lo, hi)),
        mf.mel_frontend_plain(padded, cs, fb, cfg.hop_length, (0, cfg.n_fft)),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="outside"):
        mf.mel_frontend(padded, cs, fb, cfg.hop_length, (0, cfg.n_fft + 1))


def test_cascade_checks_shapes():
    x, w, cb, s, sh = _cascade_inputs(16, 12, torch.float32, "cpu")
    with pytest.raises(ValueError, match="do not match"):
        rc.res2net_cascade(x[:, :-16], w, cb, s, sh, dilation=2)
    with pytest.raises(ValueError, match="too short"):
        rc.res2net_cascade(x[..., :6], w, cb, s, sh, dilation=3)


def _quant_inputs(x_shape, n, dtype, device, seed=0):
    """x, int8 weights [n, K], their scales, bias and a static act scale
    a little under max|x|, so that some inputs saturate."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*x_shape, generator=g)
    w = torch.randn(n, x_shape[1], generator=g) / x_shape[1] ** 0.5
    wq, s_w = qm.quantize_weight(w)
    bias = 0.1 * torch.randn(n, generator=g)
    act = 0.9 * x.abs().max().item()
    return (x.to(dtype).to(device), wq.to(device), s_w.to(device),
            bias.to(device), act)


# channels-first conv columns [B, K, T] and Dense rows [M, K]: an
# unaligned shape (K 96, N 50, ragged tiles everywhere), K not a
# multiple of 16, the Raw3_ECAPA hot layer's widths and the widest K
QUANT_SHAPES = [((3, 96, 70), 50), ((70, 96), 50), ((2, 100, 37), 130),
                ((45, 72), 129), ((4, 1024, 300), 1024), ((33, 4608), 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", QUANT_SHAPES)
def test_quant_matmul_kernel_matches_plain_exactly(cuda, x_shape, n, dtype):
    args = _quant_inputs(x_shape, n, dtype, cuda, seed=n)
    before = qm.launches
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    ref = qm.quant_matmul_plain(*args)
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


# every shape path C launches (x as the wrapper gets it, N), and the
# edges of the conv kernel's tiles and loads: T = 1 (run as Dense rows),
# T under one time tile, T = 1, 7 and 0 (mod 8), K 96, K 100 (not a
# multiple of 16 or 32) and 80 (of 16, not of 32), N 50, 192 and 320
PATH_C_QUANT_SHAPES = [
    ((160, 1024, 1575), 1024), ((160, 1024, 315), 1024),
    ((160, 1024, 105), 1024), ((160, 3072, 105), 1536),
    ((160, 4608, 105), 128), ((160, 512, 201), 512), ((160, 512, 1), 128),
    ((160, 1536, 201), 1536), ((160, 1024), 1024), ((160, 3072), 320),
    ((160, 3072), 192)]
QUANT_EDGES = [((2, 96, 1), 50), ((2, 96, 37), 50), ((1, 96, 129), 192),
               ((2, 96, 135), 192), ((2, 96, 136), 320), ((2, 100, 77), 50),
               ((2, 80, 263), 130), ((3, 96, 8), 320)]


def _check_quant_kernel(args):
    before = qm.launches
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    ref = qm.quant_matmul_plain(*args)
    assert got.dtype == args[0].dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", PATH_C_QUANT_SHAPES + QUANT_EDGES)
def test_quant_matmul_kernel_path_c_shapes_and_edges(cuda, x_shape, n, dtype):
    _check_quant_kernel(_quant_inputs(x_shape, n, dtype, cuda,
                                      seed=n + x_shape[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", [((2, 96, 41), 70), ((3, 64, 263), 300),
                                       ((37, 96), 50)])
def test_quant_matmul_kernel_takes_a_view_at_an_element_offset(
        cuda, x_shape, n, dtype):
    """x one element into a storage that ends at its last element: the
    first and last 16-byte chunks straddle x and are loaded element by
    element."""
    x, wq, s_w, b, act = _quant_inputs(x_shape, n, dtype, "cpu", seed=n)
    flat = torch.empty(1 + x.numel(), dtype=dtype, device=cuda)
    flat[1:] = x.reshape(-1).to(cuda)
    view = flat[1:].view(x_shape)
    assert view.data_ptr() % 16 and view.is_contiguous()
    _check_quant_kernel((view, wq.to(cuda), s_w.to(cuda), b.to(cuda), act))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape", [(2, 128, 201), (160, 512)])
def test_quant_matmul_kernel_saturates_at_127(cuda, x_shape, dtype):
    """A static scale far under max|x| and weights at +-127: most inputs
    clip, and the int32 sums reach 127 * 127 * K."""
    x, wq, s_w, b, _ = _quant_inputs(x_shape, 96, dtype, cuda, seed=5)
    wq = torch.where(wq >= 0, 127, -127).to(torch.int8)
    x = 50 * x
    assert (qm.quantize_act(x, 1.0).abs() == 127).float().mean() > 0.9
    _check_quant_kernel((x, wq, s_w, b, 1.0))


@pytest.mark.cuda
def test_quant_matmul_kernel_rejects_what_it_cannot_take(cuda):
    x, wq, s_w, b, act = _quant_inputs((2, 32, 20), 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x.transpose(1, 2).contiguous().transpose(1, 2),
                        wq, s_w, b, act)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qm.quant_matmul(x.half(), wq, s_w, b, act)


def test_quant_matmul_checks_shapes():
    x, wq, s_w, b, act = _quant_inputs((2, 32, 20), 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="do not match"):
        qm.quant_matmul(x[:, :16], wq, s_w, b, act)
    with pytest.raises(ValueError, match="int8"):
        qm.quant_matmul(x, wq.float(), s_w, b, act)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        qm.quant_matmul(x[0, 0], wq, s_w, b, act)


# path M3's cascade: the mixed model's ECAPA_TDNN branch (1024 channels,
# H 128) at the serving batch of raw3_ecapa.yaml's keys (160 crops of
# 2 s at 8 kHz: 201 frames)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_cascade_kernel_at_the_mixed_models_shape(cuda, dilation, dtype):
    x, w, cb, s, sh = _cascade_inputs(128, 201, dtype, cuda, seed=dilation,
                                      B=160)
    before = rc.launches
    got = rc.res2net_cascade(x, w, cb, s, sh, dilation=dilation)
    torch.cuda.synchronize()
    assert rc.launches == before + 1
    ref = rc.res2net_cascade_plain(x, w, cb, s, sh, dilation)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert _rel_err(got, ref) <= 1e-5
    else:
        assert _bf16_close(got, ref)


# K3's shapes that path M adds (x as the wrapper gets it, N): the heads of
# the mel-image encoders, RawNeXt's and ResNeXt's wide 1-D convs (the
# gates' [B, 512, 3] among them) and Denses, RawNet3 at 16 kHz, and the
# mixed model's ECAPA-1024 branch; the layers that paths C and J already
# launch are left out
MODEL_ZOO_QUANT_SHAPES = [
    ((160, 3584), 512), ((160, 1792), 512), ((160, 2560), 320),
    ((160, 2560), 256), ((160, 2048), 256), ((160, 2688), 512),
    ((160, 512, 2187), 256), ((160, 512, 729), 256), ((160, 1024, 729), 256),
    ((160, 512, 3), 170), ((160, 512, 243), 256), ((160, 512, 81), 128),
    ((160, 512, 729), 128), ((160, 1024, 243), 512), ((160, 1792, 243), 512),
    ((160, 512, 81), 256), ((160, 512, 27), 128), ((160, 512, 243), 128),
    ((160, 1536, 81), 512), ((160, 1024), 512),
    ((160, 1024, 3175), 1024), ((160, 1024, 635), 1024),
    ((160, 1024, 211), 1024), ((160, 3072, 211), 1536),
    ((160, 4608, 211), 128), ((160, 3072), 512),
    ((160, 1024, 201), 1024), ((160, 1024, 1), 128),
    ((160, 3072, 201), 3072), ((160, 6144), 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", MODEL_ZOO_QUANT_SHAPES)
def test_quant_matmul_kernel_at_the_model_zoo_shapes(cuda, x_shape, n, dtype):
    _check_quant_kernel(_quant_inputs(x_shape, n, dtype, cuda,
                                      seed=n + x_shape[1]))


def test_model_zoo_shapes_are_chip_smokes_new_ones():
    """The list above is ``chip_smoke.py``'s path-M table less the shapes
    of paths C and J, in its order."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seen = {(s, n) for s, n, _, _ in smoke.QUANT_SHAPES
            + smoke.ZOO_QUANT_SHAPES}
    new = []
    for s, n, _, _ in smoke.M_QUANT_SHAPES:
        if (s, n) not in seen:
            seen.add((s, n))
            new.append((s, n))
    assert new == MODEL_ZOO_QUANT_SHAPES
