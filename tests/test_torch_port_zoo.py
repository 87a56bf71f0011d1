"""The ResNetSE, SE-ResNet and TitaNet families and the ``hybrids2``
models, port against the JAX package (CPU, eval mode).

Module by module at small widths (the SE layers, every block kind, on a
strided image whose frequency and time axes differ; TitaNet's conv
blocks and mega block), every registered ResNetSE configuration at its
own depths and blocks with narrow filters, every SE-ResNet configuration
at its own widths on a small image, ResNetSE34V2 at full width through
``SpeakerEncoder`` (``yaml/ecapa_tdnn.yaml``'s keys), the ``mfcc`` and
``spectrogram`` features through it, and TitaNet-L, ``Tita_ECAPA``,
``Raw_tita`` and ``Res_ECAPA`` at their builders' defaults. The
modules take the JAX init through ``params_from_jax`` (which raises on a
leaf left over or missing); the models take seeded normal weights of
variance 1/fan-in drawn on the port's side, carried to JAX by
``params_to_jax`` (one JAX compile a model, not two); BatchNorm
statistics randomized either way; inputs are made with numpy from a
seed.

Tolerances: fp32 modules 2e-5 and models 1e-5 of the largest magnitude
(fp32 sums in other orders); bf16 (parameters and features cast as the
engines cast them) 2e-2 of the largest magnitude and cosine >= 0.9995
per row (two bf16 forwards round in different places).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import builder as JB
from speakerverification_tpu.models import hybrids2 as JH
from speakerverification_tpu.models import resnetse as JR
from speakerverification_tpu.models import senet as JS
from speakerverification_tpu.models import titanet as JT
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.models import hybrids2 as TH
from speakerverification_tpu_torch.models import resnetse as TR
from speakerverification_tpu_torch.models import senet as TS
from speakerverification_tpu_torch.models import titanet as TT
from speakerverification_tpu_torch.weights import cast_copy, params_from_jax

from test_torch_port_helpers import (
    close,
    port_variables,
    randomized_variables,
    t,
)

ROOT = Path(__file__).resolve().parents[1]


def feats(shape, seed: int) -> np.ndarray:
    """Positive mel-like features ``[B, T, F]``."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(0.5, 0.2, shape)) ** 2).astype(np.float32)


def jit_pair(jm, tm, *inputs, seed: int = 0) -> dict:
    """The JAX init (jitted: deep trunks init slowly op by op), BN
    randomized, loaded into ``tm`` key by key; the variables."""
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), *inputs)
    v = randomized_variables(v, seed)
    tm.load_state_dict(params_from_jax(v["params"], v.get("batch_stats"),
                                       like=tm), strict=True)
    tm.eval()
    return v


def port_pair(tm, seed: int = 0) -> dict:
    """The port's weights redrawn, BN randomized, as JAX variables
    (``port_variables``): one JAX compile (the apply) where a JAX init
    adds a second; the trees' names and shapes are held to JAX's init in
    ``test_torch_port_yamls.py``."""
    return port_variables(tm, seed)


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return t(np.transpose(x, (0, 3, 1, 2)))


# (JAX module, port module, input channels, stride)
BLOCKS = {
    "SELayer c/16": (lambda: JR.SELayer(), lambda: TR.SELayer(48), 48, 1),
    "SELayer fixed 16 biased": (
        lambda: JR.SELayer(internal=16, use_bias=True),
        lambda: TR.SELayer(48, internal=16, use_bias=True), 48, 1),
    "SEBasicBlock strided": (lambda: JR.SEBasicBlock(32, (2, 2)),
                             lambda: TR.SEBasicBlock(16, 32, 2), 16, 2),
    "SEBasicBlock": (lambda: JR.SEBasicBlock(16), lambda: TR.SEBasicBlock(
        16, 16), 16, 1),
    "SEBasicBlockV2 strided": (lambda: JR.SEBasicBlockV2(32, (2, 2)),
                               lambda: TR.SEBasicBlockV2(16, 32, 2), 16, 2),
    "SEBottleneck": (lambda: JR.SEBottleneck(8), lambda: TR.SEBottleneck(
        16, 8), 16, 1),
    "SEBottleneck strided": (lambda: JR.SEBottleneck(8, (2, 2)),
                             lambda: TR.SEBottleneck(32, 8, 2), 32, 2),
    "SENetBottleneck strided": (lambda: JS.SENetBottleneck(8, (2, 2)),
                                lambda: TR.SEBottleneck(16, 8, 2,
                                                        senet_se=True),
                                16, 2),
    "RootSEBasicBlock widening": (lambda: JH.RootSEBasicBlock(32),
                                  lambda: TH.RootSEBasicBlock(16, 32), 16, 1),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_se_blocks(name):
    make_j, make_t, cin, stride = BLOCKS[name]
    x = np.random.default_rng(1).normal(0, 1, (2, 13, 21, cin)).astype(
        np.float32)
    jm, tm = make_j(), make_t()
    kw = {} if name.startswith("SELayer") else {"train": False}
    v = jax.jit(lambda k, a: jm.init(k, a, **kw))(jax.random.PRNGKey(0),
                                                  jnp.asarray(x))
    v = randomized_variables(v, 0)
    tm.load_state_dict(params_from_jax(v["params"], v.get("batch_stats"),
                                       like=tm))
    tm.eval()
    ref = np.asarray(jm.apply(v, jnp.asarray(x), **kw))
    with torch.no_grad():
        got = tm(nhwc_to_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape[1:3] == ((7, 11) if stride == 2 else (13, 21))
    close(got, ref, 2e-5, name)


@pytest.mark.parametrize("depthwise", [False, True])
def test_titanet_conv_block(depthwise):
    x = np.random.default_rng(2).normal(0, 1, (2, 30, 24)).astype(np.float32)
    jm = JT.ConvBlock1d(32, 7, depthwise=depthwise)
    tm = TT.ConvBlock1d(24, 32, 7, depthwise=depthwise)
    v = jit_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x).transpose(1, 2)).transpose(1, 2).numpy()
    close(got, ref, 2e-5, f"ConvBlock1d depthwise={depthwise}")
    if depthwise:
        assert tm.Conv_0.groups == 24 and tm.Conv_0.weight.shape == (24, 1, 7)


def test_titanet_mega_block():
    x = np.random.default_rng(3).normal(0, 1, (2, 30, 32)).astype(np.float32)
    jm = JT.MegaBlock(32, 11)
    tm = TT.MegaBlock(32, 32, 11)
    v = jit_pair(jm, tm, jnp.asarray(x))
    assert tm.Dense_0.bias is None and tm.Dense_0.out_features == 2
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x).transpose(1, 2)).transpose(1, 2).numpy()
    close(got, ref, 2e-5, "MegaBlock")


# every registered ResNetSE configuration: (block, layers) as registered,
# filters narrowed; 24 features against 4-16 channels, so the frequency
# flatten cannot pass in the wrong order
RESNETSE = {"ResNetSE34": ("basic", (3, 4, 6, 3)),
            "ResNetSE34V2": ("basicv2", (3, 4, 6, 3)),
            "ResNetSE50": ("bottleneck", (3, 4, 6, 3)),
            "ResNetSE50V2": ("bottleneck", (3, 4, 6, 3)),
            "ResNetSE100m2": ("bottleneck", (6, 16, 24, 3)),
            "ResNetSE101": ("bottleneck", (3, 4, 23, 3)),
            "ResNetSE152": ("bottleneck", (3, 8, 36, 3))}


@pytest.mark.parametrize("name", sorted(RESNETSE))
def test_resnetse_configs_at_small_width(name):
    torch.set_num_threads(2)
    block, layers = RESNETSE[name]
    kw = dict(nOut=24, block=block, layers=layers,
              num_filters=(4, 8, 8, 16))
    x = feats((2, 37, 24), seed=4)
    jm, tm = JR.ResNetSE(**kw), TR.ResNetSE(n_mels=24, **kw)
    v = port_pair(tm)
    # 24 -> 12 -> 6 -> 3 frequency bins, flattened into the channels
    expansion = 4 if block == "bottleneck" else 1
    assert tm.Conv_1.in_channels == 16 * expansion * 3
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 1e-5, name)


def test_resnetse_sap_without_log():
    kw = dict(nOut=16, block="basic", layers=(2, 1), num_filters=(8, 16),
              encoder_type="SAP", log_input=False)
    x = np.random.default_rng(5).normal(0, 1, (2, 30, 20)).astype(np.float32)
    jm, tm = JR.ResNetSE(**kw), TR.ResNetSE(n_mels=20, **kw)
    v = jit_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 1e-5, "ResNetSE SAP")


SENET = {"se_resnet18": ("basic", (2, 2, 2, 2)),
         "se_resnet34": ("basic", (3, 4, 6, 3)),
         "se_resnet50": ("bottleneck", (3, 4, 6, 3)),
         "se_resnet101": ("bottleneck", (3, 4, 23, 3)),
         "se_resnet152": ("bottleneck", (3, 8, 36, 3))}


@pytest.mark.parametrize("name", sorted(SENET))
def test_se_resnet_configs(name):
    """Each configuration at its own widths (64·2^stage planes) on a
    small image (40 frames x 24 features)."""
    torch.set_num_threads(2)
    block, layers = SENET[name]
    x = feats((2, 40, 24), seed=6)
    jm = JS.SEResNet(nOut=32, block=block, layers=layers)
    tm = TB.build_model(name, nOut=32, n_mels=24)
    assert isinstance(tm, TS.SEResNet)
    v = port_pair(tm)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 1e-5, name)


def ecapa_yaml_hparams(model: dict, samples: int = 16000, **extra) -> dict:
    """``yaml/ecapa_tdnn.yaml``'s keys with ``model`` and crops of
    ``samples`` (16 kHz), the plain frontend."""
    h = read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    spec = dict(h["audio_spec"])
    spec["sentence_len"] = samples / spec["sample_rate"]
    return {**h, "audio_spec": spec, "frontend_backend": "xla",
            "model": {**h["model"], **model}, **extra}


def _through_encoder(h: dict, x: np.ndarray, rel: float, what: str,
                     n_params=None) -> np.ndarray:
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    v = port_pair(tm)
    if n_params is not None:
        assert sum(p.numel() for p in tm.backbone.parameters()) == n_params
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, rel, what)
    return got


def _waves(n: int, samples: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, samples))
            ).astype(np.float32)


def test_resnetse34v2_full_width_through_speaker_encoder():
    h = ecapa_yaml_hparams({"name": "ResNetSE34V2"})
    got = _through_encoder(h, _waves(2, 16000, seed=7), 1e-5,
                           "ResNetSE34V2", n_params=7_027_488)
    assert got.shape == (2, 192)


@pytest.mark.parametrize("features", ["mfcc", "spectrogram"])
def test_resnetse34v2_on_mfcc_and_spectrogram(features):
    """The model takes the feature type's width (n_mfcc 80; 257 bins)
    and skips the log + CMN, as its JAX builder does."""
    h = ecapa_yaml_hparams({"name": "ResNetSE34V2",
                            "feature_type": features}, samples=8000,
                           features=features)
    tm = TB.encoder_from_hparams(h)
    assert not tm.backbone.log_input
    width = 80 if features == "mfcc" else 257
    assert tm.backbone.Conv_1.in_channels == 256 * -(-width // 8)
    _through_encoder(h, _waves(2, 8000, seed=8), 1e-5,
                     f"ResNetSE34V2 on {features}")


# the models with in-model featurizers take raw waves (features: raw);
# Raw_tita's sample LayerNorm is sized to the 9,000-sample crop
BUILDER_DEFAULTS = {
    "TitaNet": ({"name": "TitaNet", "feature_type": "melspectrogram",
                 "nOut": 192}, "melspectrogram", 8000),
    "Tita_ECAPA": ({"name": "Tita_ECAPA", "feature_type": "raw",
                    "nOut": 512}, "raw", 8000),
    "Raw_tita": ({"name": "Raw_tita", "feature_type": "raw", "nOut": 512},
                 "raw", 9000),
    "Res_ECAPA": ({"name": "Res_ECAPA", "feature_type": "melspectrogram",
                   "nOut": 128}, "melspectrogram", 8000),
}


@pytest.mark.parametrize("name", sorted(BUILDER_DEFAULTS))
def test_builder_defaults_through_speaker_encoder(name):
    torch.set_num_threads(2)
    model, features, samples = BUILDER_DEFAULTS[name]
    h = ecapa_yaml_hparams(model, samples=samples, features=features)
    got = _through_encoder(h, _waves(2, samples, seed=9), 1e-5, name)
    assert got.shape == (2, model["nOut"])


def test_titanet_depth_search_and_sizes():
    """The depth follows JAX's search, which depends on the embedding
    width (Tita_ECAPA's TitaNet-M at 320 against Raw_tita's at 192)."""
    for emb in (64, 192, 320, 512):
        for size in ("s", "m", "l"):
            assert TT.find_n_mega_blocks(emb, 80, size) == \
                JT.find_n_mega_blocks(emb, 80, size)
            assert TT.titanet_param_count(emb, 80, 3, size) == \
                JT.titanet_param_count(emb, 80, 3, size)
    tita = TB.build_model("Tita_ECAPA", nOut=512, n_mels=80)
    raw = TB.build_model("Raw_tita", nOut=512, n_mels=80)
    assert tita.titanet.n_mega == JT.find_n_mega_blocks(320, 80, "m")
    assert raw.titanet.n_mega == JT.find_n_mega_blocks(192, 80, "m")
    big = TB.build_model("TitaNet", nOut=192, n_mels=80)
    assert big.MegaBlock_0.ConvBlock1d_0.Conv_0.kernel_size == (11,)
    assert big.n_mega == JT.find_n_mega_blocks(192, 80, "l")


def _bf16_params(v):
    return {"params": jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                                   v["params"]),
            "batch_stats": v["batch_stats"]}


BF16 = {
    "ResNetSE": (lambda: JR.ResNetSE(nOut=24, block="basicv2",
                                     layers=(1, 2), num_filters=(8, 16)),
                 lambda: TR.ResNetSE(n_mels=24, nOut=24, block="basicv2",
                                     layers=(1, 2), num_filters=(8, 16))),
    "SEResNet": (lambda: JS.SEResNet(nOut=24, layers=(1, 1)),
                 lambda: TS.SEResNet(nOut=24, layers=(1, 1))),
    "TitaNet": (lambda: JT.TitaNet(nOut=24, hidden_size=64, n_mega_blocks=2,
                                   encoder_output_size=96),
                lambda: TT.TitaNet(n_mels=24, nOut=24, hidden_size=64,
                                   n_mega_blocks=2, encoder_output_size=96)),
    "ResECAPA": (lambda: JH.ResECAPA(nOut=24,
                                     ecapa_channels=(32, 32, 32, 32, 96)),
                 lambda: TH.ResECAPA(n_mels=24, nOut=24,
                                     ecapa_channels=(32, 32, 32, 32, 96))),
}


@pytest.mark.parametrize("name", sorted(BF16))
def test_bf16_matches_jax_bf16(name):
    x = feats((3, 60, 24), seed=10)
    jm, tm = BF16[name][0](), BF16[name][1]()
    v = port_pair(tm)
    ref = jax.jit(jm.apply)(_bf16_params(v),
                            jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        got = cast_copy(tm, torch.bfloat16).eval()(t(x).to(torch.bfloat16))
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    ref, got = np.asarray(ref, np.float32), got.float().numpy()
    close(got, ref, 2e-2, f"{name} bf16")
    cos = np.sum(got * ref, 1) / (np.linalg.norm(got, axis=1)
                                  * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.9995, cos


def test_hybrids_featurize_with_the_mel_kernel_route():
    """``Tita_ECAPA`` and ``Raw_tita`` featurize in-model through
    ``hybrid_featurize`` (the mel kernel on CUDA); ``Res_ECAPA`` and the
    plain families take the encoder's features, and no ECAPA here takes
    the cascade kernel."""
    h = ecapa_yaml_hparams({"name": "Tita_ECAPA", "feature_type": "raw"},
                           features="raw", frontend_backend="pallas")
    tm = TB.encoder_from_hparams(h)
    assert tm.feature_type == "raw"
    assert tm.backbone.frontend_backend == "pallas"
    assert tm.backbone.frontend.sample_rate == 16000
    for model in ("Res_ECAPA", "Tita_ECAPA"):
        m = TB.build_model(model, nOut=512, n_mels=80, conv_backend="pallas")
        assert all(b.backend == "xla" for n, b in m.named_modules()
                   if type(b).__name__ == "Res2NetBlock"), model
