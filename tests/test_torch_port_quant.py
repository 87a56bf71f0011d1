"""Port int8 extraction (``quant.py``, ``ops/quant_matmul.py``) against the
JAX package on the CPU.

* K3's plain version against JAX ``quant_matmul`` in interpret mode: the
  int8 activations and weights identical, the output within 1e-6 of
  its largest magnitude (fp32 epilogue; XLA may fuse its multiply-add);
* ``_int8_gemm`` against JAX ``_int8_gemm`` (same divisions, exact sums):
  within 1e-6 of the largest magnitude;
* the exact-arithmetic conv and Dense cases of ``tests/test_quant.py``
  (power-of-two grids, so int8 reproduces the float layer exactly);
* floors, strided and grouped convs: bit-equal to the float path;
* calibration keys and values against JAX on a small Raw3_ECAPA hybrid:
  values within 1e-5 relative in the ECAPA branch, 5e-4 in the raw
  branch, whose log-sinc features amplify rounding differences (its
  float activations agree to ~1e-4 of their max, the RawNet3 tolerance
  of ``test_torch_port_models``);
* int8 embeddings with JAX's scales against JAX ``make_int8_embed_fn``:
  the ECAPA half at cosine >= 0.9999 per row; the whole embedding at
  >= 0.9998 and closer to JAX's int8 embedding than that is to JAX's
  float one. The raw branch's float differences flip int8 rounding
  decisions (measured: ECAPA half 1.0000000, whole 0.99990 at worst,
  and the same with the port dividing as JAX does), so the whole
  embedding cannot hold 0.9999;
* the engine's calibrated key set at the default floors (ECAPA 512), and
  the serving warm-up, which must not calibrate.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from speakerverification_tpu import quant as jquant
from speakerverification_tpu.builder import encoder_from_hparams as j_encoder
from speakerverification_tpu.encoder import SpeakerEncoder as JEncoder
from speakerverification_tpu.ops.pallas_quant import quant_matmul as j_qmm
from speakerverification_tpu_torch import quant as tquant
from speakerverification_tpu_torch import serving as tserving
from speakerverification_tpu_torch.encoder import SpeakerEncoder as TEncoder
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.ops import quant_matmul as qm
from speakerverification_tpu_torch.weights import (
    act_scales_from_jax,
    params_from_jax,
)

from test_torch_port_helpers import randomized_variables, t
from test_torch_port_models import _small_hybrid, _wave

DEAD = "AttentiveStatisticsPooling_0/TDNNBlock_0/Conv1d_0/Conv_0"


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("M,K,N", [(70, 96, 50), (40, 4608, 128)])
def test_k3_plain_matches_jax_interpret(M, K, N):
    rng = np.random.default_rng(K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    act = 0.8 * float(np.max(np.abs(x)))             # some inputs saturate
    ref = np.asarray(j_qmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           act, block_m=64, interpret=True))

    # the TPU kernel's quantization steps, written out
    s_x = max(act / 127.0, 1e-12)
    xq_j = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / s_x)), -127, 127)
    wf = jnp.asarray(w)
    s_w = jnp.maximum(jnp.max(jnp.abs(wf), axis=0) / 127.0, 1e-12)
    wq_j = jnp.clip(jnp.round(wf / s_w[None, :]), -127, 127)

    wq, s_w_t = qm.quantize_weight(t(w.T))
    np.testing.assert_array_equal(qm.quantize_act(t(x), act).numpy(),
                                  np.asarray(xq_j))
    np.testing.assert_array_equal(wq.numpy().T, np.asarray(wq_j))
    np.testing.assert_array_equal(s_w_t.numpy(), np.asarray(s_w))
    got = qm.quant_matmul(t(x), wq, s_w_t, t(b), act)      # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel(got, ref) <= 1e-6
    # the channels-first layout is the same product, bit for bit
    x3 = t(x.reshape(2, M // 2, K).transpose(0, 2, 1))
    got3 = qm.quant_matmul(x3, wq, s_w_t, t(b), act)
    assert torch.equal(got3.transpose(1, 2).reshape(M, N), got)


@pytest.mark.parametrize("act", [None, 2.5])
def test_int8_gemm_matches_jax(act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(33, 64)).astype(np.float32)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    ref = np.asarray(jquant._int8_gemm(jnp.asarray(x), jnp.asarray(w), act))
    got = tquant._int8_gemm(t(x), t(w), act)
    assert _rel(got, ref) <= 1e-6


ALL = dict(min_k=1, min_n=1)


def _grid(rng, shape, scale, per_channel_axis=None):
    """Integers in [-31, 31] times ``scale`` with a ±127 entry (per
    channel when asked), as ``tests/test_quant.py`` builds them."""
    v = rng.integers(-31, 32, size=shape).astype(np.float32)
    if per_channel_axis is None:
        v.reshape(-1)[0] = 127.0
    else:
        v = np.moveaxis(v, per_channel_axis, -1)
        v[(0,) * (v.ndim - 1) + (slice(None),)] = 127.0
        v = np.moveaxis(v, -1, per_channel_axis)
    return (v * scale).astype(np.float32)


@pytest.mark.parametrize("k,dilation,padding", [
    (1, 1, "VALID"), (3, 1, "SAME"), (3, 2, "SAME"), (3, 4, "VALID"),
    (5, 1, "SAME"), (5, 3, "SAME"), (4, 2, "SAME")])
def test_int8_conv_exact_arithmetic(k, dilation, padding):
    rng = np.random.default_rng(k * 10 + dilation)
    cin, cout, T = 12, 7, 40
    x = _grid(rng, (2, T, cin), 2.0 ** -5)
    kernel = _grid(rng, (k, cin, cout), 2.0 ** -6, per_channel_axis=2)
    bias = _grid(rng, (cout,), 2.0 ** -4)
    jmod = jquant.nn.Conv(cout, (k,), kernel_dilation=(dilation,),
                          padding=padding)
    ref = np.asarray(jmod.apply({"params": {"kernel": kernel, "bias": bias}},
                                jnp.asarray(x)))
    conv = tnn.Conv1d(cin, cout, k, dilation=dilation,
                      padding="same" if padding == "SAME" else 0)
    with torch.no_grad():
        conv.weight.copy_(t(kernel.transpose(2, 1, 0)))
        conv.bias.copy_(t(bias))
    xt = t(x.transpose(0, 2, 1))
    _assert_int8_exact(conv, xt, ref.transpose(0, 2, 1), float(np.max(np.abs(x))))


def _assert_int8_exact(layer, x, ref, act):
    """Dynamic and static int8 reproduce ``ref`` exactly on the grid, and
    the int8 path did run: off the grid it differs from the float layer."""
    cfg = tquant.QuantConfig(**ALL)
    # dynamic (_int8_gemm); static (K3's wrapper)
    for scales in (None, {"": act}):
        assert isinstance(tquant.quantize_model(copy.deepcopy(layer), cfg,
                                                scales), tquant._QuantGemm)
        got = tquant.int8_apply(layer, x, config=cfg, act_scales=scales)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
        off_grid = x + 2.0 ** -9
        with torch.no_grad():
            assert not torch.equal(tquant.int8_apply(
                layer, off_grid, config=cfg, act_scales=scales),
                layer(off_grid))


def test_int8_dense_exact_arithmetic():
    rng = np.random.default_rng(0)
    x = _grid(rng, (3, 5, 16), 2.0 ** -5)
    kernel = _grid(rng, (16, 9), 2.0 ** -6, per_channel_axis=1)
    bias = _grid(rng, (9,), 2.0 ** -4)
    ref = np.asarray(jquant.nn.Dense(9).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    lin = tnn.Linear(16, 9)
    with torch.no_grad():
        lin.weight.copy_(t(kernel.T))
        lin.bias.copy_(t(bias))
    _assert_int8_exact(lin, t(x), ref, float(np.max(np.abs(x))))


class _Two(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv1d(4, 8, 3, padding=1)          # K 12 < 64
        self.fc = tnn.Linear(8, 4)                          # K 8 < 64

    def forward(self, x):
        return self.fc(self.conv(x).transpose(1, 2))


class _StridedGrouped(tnn.Module):
    def __init__(self):
        super().__init__()
        self.a = tnn.Conv1d(8, 8, 3, stride=2, padding=1)
        self.b = tnn.Conv1d(8, 8, 3, groups=4, padding=1)

    def forward(self, x):
        return self.a(x).sum() + self.b(x).sum()


@pytest.mark.parametrize("model,cfg,shape", [
    (_Two, dict(min_k=64, min_n=2), (2, 4, 10)),
    (_StridedGrouped, ALL, (2, 8, 12))])
def test_layers_left_float_are_bit_equal(model, cfg, shape):
    torch.manual_seed(0)
    m = model().eval()
    x = torch.randn(*shape)
    config = tquant.QuantConfig(**cfg)
    assert not any(tquant.quantizable(mod, config) for mod in m.modules())
    with torch.no_grad():
        assert torch.equal(tquant.int8_apply(m, x, config=config), m(x))


SMALL_FLOORS = dict(min_k=16, min_n=8)


def _jit_init(jm, x):
    """Flax variables (jitted init: eager init of these models takes
    seconds per layer stack) with BN statistics randomized."""
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return randomized_variables(v, seed=0)


@pytest.fixture(scope="module")
def hybrid_pair():
    """A small Raw3_ECAPA hybrid in both packages with JAX's weights,
    and JAX's calibrated scales at floors that quantize both branches."""
    x = _wave((4, 4000), seed=7)
    jh, th = _small_hybrid()
    jm = JEncoder(backbone=jh, feature_type="raw", frontend_backend="xla")
    tm = TEncoder(backbone=th, feature_type="raw")
    v = _jit_init(jm, x)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm))
    tm.eval()
    jscales = jquant.calibrate_act_scales(
        jm, v, jnp.asarray(x[:2]), config=jquant.QuantConfig(**SMALL_FLOORS))
    return jm, tm, v, x, jscales


def test_calibrate_act_scales_matches_jax(hybrid_pair):
    torch.set_num_threads(2)
    jm, tm, v, x, jscales = hybrid_pair
    got = tquant.calibrate_act_scales(
        tm, t(x[:2]), config=tquant.QuantConfig(**SMALL_FLOORS))
    dead = {k for k in jscales if k.endswith(DEAD)}
    assert dead == {f"backbone/ecapa/{DEAD}"} and jscales[dead.pop()] == 0.0
    assert set(got) == {k for k in jscales if not k.endswith(DEAD)}
    assert any(k.startswith("backbone/raw_branch/") for k in got)
    assert any(k.startswith("backbone/ecapa/") for k in got)
    for k, val in got.items():
        # the raw branch reads log(|sinc| + 1e-6) features, which amplify
        # the frameworks' rounding differences of near-zero filter
        # outputs: its activations agree to ~1e-4 of their max (the
        # RawNet3 tolerance of test_torch_port_models), and the max of
        # the log features sits where the log is steepest (1.0e-4 here)
        rel = 5e-4 if k.startswith("backbone/raw_branch/") else 1e-5
        assert val == pytest.approx(jscales[k], rel=rel), k


def test_int8_embeddings_match_jax(hybrid_pair):
    jm, tm, v, x, jscales = hybrid_pair
    scales = act_scales_from_jax(jscales, tm,
                                 tquant.QuantConfig(**SMALL_FLOORS))
    ref = np.asarray(jquant.make_int8_embed_fn(
        jm, config=jquant.QuantConfig(**SMALL_FLOORS), act_scales=jscales)(
        v["params"], v["batch_stats"], jnp.asarray(x)))
    before = qm.launches
    got = tquant.make_int8_embed_fn(
        tm, config=tquant.QuantConfig(**SMALL_FLOORS), act_scales=scales)(t(x))
    assert qm.launches == before                # CPU tensors never launch
    got = got.numpy()

    def cos(a, b):
        return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                        * np.linalg.norm(b, axis=1))

    assert cos(got[:, :16], ref[:, :16]).min() >= 0.9999
    to_jax = cos(got, ref)
    float_ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert to_jax.min() >= 0.9998, to_jax
    assert np.all(1 - to_jax < 1 - cos(ref, float_ref)), to_jax
    with pytest.raises(KeyError, match="names no quantizable module"):
        act_scales_from_jax({**jscales, "backbone/nope": 1.0}, tm,
                            tquant.QuantConfig(**SMALL_FLOORS))


def _ecapa512_hparams(**extra):
    return {"seed": 0, "num_eval": 2,
            "audio_spec": {"sample_rate": 8000, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 80, "features": "melspectrogram",
            "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                      "nOut": 192, "channels": [512, 512, 512, 512, 1536]},
            "quant": "int8", "serving": {"batch_utts": 2, "max_wait_ms": 5},
            **extra}


def test_engine_calibrates_jax_key_set_at_default_floors():
    """ECAPA at 512 channels: the default floors quantize its 1×1 convs,
    SE squeeze and MFA convs and the final Dense (11 layers)."""
    torch.set_num_threads(2)
    h = _ecapa512_hparams()
    waves = _wave((3, 4000), seed=11)
    engine = InferenceEngine(h, device="cpu")
    emb = engine.embed_fn(waves)
    assert emb.shape == (3, 192) and torch.isfinite(emb).all()
    jm = j_encoder({**h, "quant": None}, with_loss=False, num_devices=1)
    v = _jit_init(jm, waves[:2])
    jscales = jquant.calibrate_act_scales(jm, v, jnp.asarray(waves))
    assert set(engine.act_scales) == {k for k in jscales
                                      if not k.endswith(DEAD)}
    assert len(engine.act_scales) == 11


def test_serving_warm_up_leaves_calibration_to_the_first_request():
    h = _ecapa512_hparams()
    engine = InferenceEngine(h, device="cpu")
    handler, batcher = tserving.make_serving_app(engine, h)
    try:
        tserving.warm_up(engine, batcher)
        assert engine.act_scales is None
        crops = _wave((2, 4000), seed=12)
        emb = batcher.submit(crops).result(timeout=60)
        assert emb.shape == (2, 192)
        assert len(engine.act_scales) == 11
        assert min(engine.act_scales.values()) > 0
    finally:
        batcher.close()


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="quant"):
        InferenceEngine(_ecapa512_hparams(quant="int4"), device="cpu")
