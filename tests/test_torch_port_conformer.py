"""The Conformer family, port against the JAX package (CPU, eval mode).

Module by module at small widths (dim 32–64, one or two blocks), then
``Conformer`` at ``yaml/model_plot.yaml``'s full width through
``SpeakerEncoder`` and ``ECAPAConformer`` at the JAX test's small width,
each with the JAX init's weights (``params_from_jax``, which raises on a
leaf left over or missing) and BatchNorm statistics randomized. Inputs
are made with numpy from a seed.

Tolerances: the shift is exact; the positional encoding 2 ulps of its
largest angle (``T · 2^-22``: the angles ``t · exp(...)`` differ by an
ulp of ``exp`` between the two libraries, and ``sin``/``cos`` pass it
on); each module's fp32 output 2e-5 of its largest magnitude,
the full models 1e-5 of theirs (fp32 sums in other orders, LayerNorm's
variance by two passes where flax takes E[x²] − E[x]²). bf16: the port
and JAX both give fp32 (the positional term promotes the residual
stream) and agree within 2e-2 of the largest magnitude, cosine ≥ 0.9995
per row (two bf16 forwards of one model round in different places).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import builder as JB
from speakerverification_tpu.models import conformer as JC
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.models import conformer as TC
from speakerverification_tpu_torch.weights import cast_copy

from test_torch_port_helpers import close, init_pair, randomized_variables, t

ROOT = Path(__file__).resolve().parents[1]


def _feats(shape, seed: int) -> np.ndarray:
    """Positive mel-like features ``[B, T, F]``."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(0.5, 0.2, shape)) ** 2).astype(np.float32)


def _normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).normal(0, 1, shape)).astype(
        np.float32)


def test_relative_shift_is_exact():
    x = _normal((2, 3, 7, 7), seed=0)
    np.testing.assert_array_equal(
        TC.relative_shift(t(x)).numpy(),
        np.asarray(JC._relative_shift(jnp.asarray(x))))


@pytest.mark.parametrize("T,d", [(49, 256), (100, 144), (5, 8)])
def test_sinusoidal_pe(T, d):
    close(TC.sinusoidal_pe(T, d).numpy(), np.asarray(JC._sinusoidal_pe(T, d)),
          T * 2.0 ** -22, "pe")


def test_relative_attention():
    dim, heads, T = 64, 4, 12
    x = _normal((2, T, dim), seed=1)
    pos = np.asarray(JC._sinusoidal_pe(T, dim))[None]
    jm = JC.RelativeMultiHeadAttention(dim, heads)
    tm = TC.RelativeMultiHeadAttention(dim)
    v = init_pair(jm, tm, jnp.asarray(x), jnp.asarray(pos))
    # u_bias / v_bias carried as they are
    np.testing.assert_array_equal(tm.u_bias.detach().numpy(),
                                  np.asarray(v["params"]["u_bias"]))
    ref = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(pos)))
    with torch.no_grad():
        got = tm(t(x), t(pos)).numpy()
    close(got, ref, 2e-5, "attention")


@pytest.mark.parametrize("kernel", [15, 31])
def test_conv_module(kernel):
    dim = 32
    x = _normal((2, 40, dim), seed=2)
    jm = JC._ConvModule(dim, kernel)
    tm = TC.ConvModule(dim, kernel)
    v = init_pair(jm, tm, jnp.asarray(x))
    assert tm.Conv_0.padding == "same" and tm.Conv_0.bias is None
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 2e-5, f"conv module k{kernel}")


def test_conformer_block():
    dim = 64
    x = _normal((2, 30, dim), seed=3)
    jm = JC.ConformerBlock(dim, num_heads=4, conv_kernel=15)
    tm = TC.ConformerBlock(dim, conv_kernel=15)
    v = init_pair(jm, tm, jnp.asarray(x))
    # flax's LayerNorm epsilon
    assert all(m.eps == 1e-6 for m in tm.modules()
               if isinstance(m, torch.nn.LayerNorm))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 2e-5, "block")


def test_conformer_encoder():
    # F = 20 features -> 4 after subsampling, against C = 48 channels: a
    # flatten in the wrong order cannot pass
    x = _normal((2, 41, 20), seed=4)
    jm = JC.ConformerEncoder(48, num_layers=2, conv_kernel=15)
    tm = TC.ConformerEncoder(20, 48, num_layers=2, conv_kernel=15)
    v = init_pair(jm, tm, jnp.asarray(x))
    assert tuple(tm.Dense_0.weight.shape) == (48, 4 * 48)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, 9, 48)
    close(got, ref, 2e-5, "encoder")


def model_plot_hparams(samples: int = 16000) -> dict:
    """``yaml/model_plot.yaml`` with crops of ``samples`` and the plain
    mel frontend."""
    h = read_config(ROOT / "yaml" / "model_plot.yaml")
    spec = dict(h["audio_spec"])
    spec["sentence_len"] = samples / spec["sample_rate"]
    return {**h, "audio_spec": spec, "frontend_backend": "xla"}


def test_conformer_full_width_through_speaker_encoder():
    h = model_plot_hparams()
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    assert isinstance(tm.backbone, TC.ConformerSpeaker)
    x = _normal((2, 16000), seed=5, scale=0.1)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = randomized_variables(v, seed=0)
    from speakerverification_tpu_torch.weights import params_from_jax
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm))
    tm.eval()
    n = sum(p.numel() for p in tm.backbone.parameters())
    assert n == 11_675_936
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, 512)
    close(got, ref, 1e-5, "Conformer")


SMALL_ECAPA = dict(nOut=24, channels=(32, 32, 32, 32, 96), res2net_scale=4,
                   se_channels=8, attention_channels=8, encoder_dim=32,
                   num_layers=2)


def test_ecapa_conformer_small():
    x = _feats((2, 100, 40), seed=6)
    jm = JC.ECAPAConformer(**SMALL_ECAPA)
    tm = TC.ECAPAConformer(n_mels=40, **SMALL_ECAPA)
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, 24)
    close(got, ref, 1e-5, "ECAPA_Conformer")


def test_builders_read_the_jax_keys():
    m = TB.build_model("ECAPA_Conformer", nOut=192, n_mels=80)
    n = sum(p.numel() for p in m.parameters())
    assert n == 21_175_728
    # conv_backend is ignored, as by the JAX builder: the cascade stays
    # plain
    m = TB.build_model("ECAPA_Conformer", nOut=16, n_mels=40,
                       channels=[16, 16, 16, 16, 48], encoder_dim=16,
                       num_layers=1, conv_backend="pallas")
    assert m.SERes2NetBlock_0.Res2NetBlock_0.backend == "xla"
    m = TB.build_model("Conformer", nOut=64, n_mels=40, encoder_dim=32,
                       num_layers=3, feature_type="raw")
    assert m.feature_type == "raw" and m.ConformerEncoder_0.num_layers == 3
    assert m.ConformerEncoder_0.ConformerBlock_0._ConvModule_0.Conv_0 \
        .kernel_size == (15,)


def _bf16_params(v):
    return {"params": jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                                   v["params"]),
            "batch_stats": v["batch_stats"]}


@pytest.mark.parametrize("model", ["Conformer", "ECAPA_Conformer"])
def test_bf16_matches_jax_bf16(model):
    """bf16 parameters and bf16 features, as the engines run mixedprec."""
    x = _feats((3, 80, 40), seed=7)
    if model == "Conformer":
        jm = JC.ConformerSpeaker(nOut=32, encoder_dim=64, num_layers=2)
        tm = TC.ConformerSpeaker(n_mels=40, nOut=32, encoder_dim=64,
                                 num_layers=2)
    else:
        jm = JC.ECAPAConformer(**SMALL_ECAPA)
        tm = TC.ECAPAConformer(n_mels=40, **SMALL_ECAPA)
    v = init_pair(jm, tm, jnp.asarray(x))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax.jit(jm.apply)(_bf16_params(v), xb)
    with torch.no_grad():
        got = cast_copy(tm, torch.bfloat16).eval()(
            t(x).to(torch.bfloat16))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    ref, got = np.asarray(ref), got.numpy()
    close(got, ref, 2e-2, f"{model} bf16")
    cos = np.sum(got * ref, 1) / (np.linalg.norm(got, axis=1)
                                  * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.9995, cos
