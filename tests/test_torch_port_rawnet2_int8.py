"""int8 extraction of the RawNet2 family, port against the JAX package
(CPU).

* Static mode (``calibrate_act_scales`` then K3's plain version):
  ``Raw_ECAPA_conv_asp`` and ``Raw_tita`` at full width through
  ``SpeakerEncoder`` (crops cut to 9,000 samples): the scales under JAX's
  keys (the raw branch's 3-tap convs, AFMS Denses, ASP conv and
  embedding Dense, ``Raw_tita``'s TitaNet 1×1 convs and pooling Dense)
  within 1e-5 relative, and the int8 embeddings with JAX's scales: the
  mel branch's 192 at cosine >= 0.9999 per row to JAX int8. The raw
  branch's static int8 is chaotic in JAX itself: a 1e-6 relative change
  of the wave leaves its float output in place but moves its int8
  ``Raw_tita`` raw half to cosine 0.9987 (measured; rounding decisions
  flip, and its activations sit near the rounding boundaries), and the
  port's thread count moves the port's alike. So the whole embedding is
  held at cosine >= 0.998 per row and at most twice as far from JAX
  int8 as JAX int8 moves under that 1e-6 change (floor 5e-4; measured
  0.9983–0.9999 against JAX's own 0.9987).
* Dynamic mode (``int8_apply`` without scales) of the GRU: flax's cell
  calls its input ``Dense`` once per step inside ``nn.RNN``'s scan, so
  each step's input product, and each recurrent product, takes that
  step's own max-abs scale. The cell alone, on a sequence whose steps
  differ in level by 500x, within 1e-3 of the largest output (measured
  2.4e-4: the two packages' ``sigmoid``/``tanh`` round apart and flip
  int8 decisions; one scale over the sequence is 0.28 off at the first
  step); ``RawNet2`` and ``RawNet2Custom(gru)`` at full width at cosine
  >= 0.995 to JAX int8 per row and closer to it than JAX int8 is to
  float (measured 0.9981 at worst, JAX int8 to float 0.9925).
* Static calibration of the GRU models fails in the JAX package
  (``ConcretizationTypeError``: a traced max read with ``float()``) and
  is refused by the port with its reason: both sides are held, so a
  change in either is seen.
"""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import builder as JB
from speakerverification_tpu import quant as jquant
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch import quant as tquant
from speakerverification_tpu_torch.models.recurrent import GRUCell
from speakerverification_tpu_torch.weights import (
    act_scales_from_jax,
    params_from_jax,
)

from test_torch_port_helpers import init_pair, randomized_variables, t
from test_torch_port_rawnet2_builders import T, hparams_for


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


def _waves(n: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, T))).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _pair(model: str, yaml_name: str):
    """Both packages' model of the yaml, the JAX init (jitted) carried to
    the port, BN randomized; built once per model (no test edits it)."""
    h = hparams_for(model, yaml_name)
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    x = _waves(3, seed=0)
    v = randomized_variables(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x)), seed=0)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm))
    tm.eval()
    return jm, tm, v, x


# layers JAX's static int8 quantizes (the dead ECAPA pooling key, a
# recorded 0.0, included), the raw branch's share, and its ASP attention
# conv (the strided-conv front is its Conv_0)
STATIC = {"Raw_ECAPA_conv_asp": (28, 16, "Conv_1"),
          "Raw_tita": (59, 16, "Conv_0")}


@pytest.mark.parametrize("model", sorted(STATIC))
def test_static_int8_matches_jax(model):
    torch.set_num_threads(2)
    jm, tm, v, x = _pair(model, "voxceleb_raw_ecapa.yaml")
    jscales = jquant.calibrate_act_scales(jm, v, jnp.asarray(x[:2]))
    got = tquant.calibrate_act_scales(tm, t(x[:2]))
    n_all, n_raw, asp_conv = STATIC[model]
    assert len(jscales) == n_all
    live = {k: s for k, s in jscales.items() if s > 0.0}
    assert set(got) == set(live)
    assert len([k for k in got if "/raw_branch/" in k]) == n_raw
    for key in ("RawNetBasicBlock_3/Conv_0", "RawNetBasicBlock_7/Conv_1",
                "RawNetBasicBlock_5/AFMS_0/Dense_0", asp_conv, "Dense_0"):
        assert f"backbone/raw_branch/{key}" in got, key
    for k, val in got.items():
        assert val == pytest.approx(jscales[k], rel=1e-5), k
    scales = act_scales_from_jax(jscales, tm)
    jax_int8 = jquant.make_int8_embed_fn(jm, act_scales=jscales)
    ref = np.asarray(jax_int8(v["params"], v["batch_stats"], jnp.asarray(x)))
    emb = tquant.make_int8_embed_fn(tm, act_scales=scales)(t(x)).numpy()
    # the mel branch (ECAPA or TitaNet, the first 192) as tight as the
    # ECAPA-only models
    assert _cos(emb[:, :192], ref[:, :192]).min() >= 0.9999
    # the raw branch's static int8 is as far from itself in JAX when the
    # wave moves by 1e-6 (its float output does not move)
    nudge = 1 + 1e-6 * np.random.default_rng(1).normal(0, 1, x.shape)
    moved = np.asarray(jax_int8(v["params"], v["batch_stats"],
                                jnp.asarray((x * nudge).astype(np.float32))))
    to_jax = _cos(emb, ref)
    assert to_jax.min() >= 0.998, to_jax
    assert (1 - to_jax).max() <= max(2 * (1 - _cos(moved, ref)).max(),
                                     5e-4), to_jax


class _JaxRNN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.RNN(fnn.GRUCell(1024))(x)


class _PortRNN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.GRUCell_0 = GRUCell(512, 1024)

    def forward(self, x):
        return self.GRUCell_0(x)


def test_dynamic_int8_gru_cell_scales_each_step():
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    level = np.array([0.1, 1.0, 10.0, 0.5, 3.0, 0.02], np.float32)
    x = (rng.normal(0, 1, (2, 6, 512)) * level[None, :, None]).astype(
        np.float32)
    jm, tm = _JaxRNN(), _PortRNN()
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jquant.int8_apply(jm, v, jnp.asarray(x)))
    got = tquant.int8_apply(tm, t(x)).numpy()
    top = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * top
    # int8 moves the cell far from float: the check above is not the
    # float path's
    float_ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert np.abs(float_ref - ref).max() > 0.1 * top
    # every product of the cell quantized (K 512 and 1,024), and the
    # input products run step by step: one scale over the sequence is
    # another function
    cell = tquant.quantize_model(copy.deepcopy(tm)).GRUCell_0
    assert all(isinstance(getattr(cell, k), tquant.QuantLinear)
               for k in ("ir", "iz", "in", "hr", "hz", "hn"))
    with torch.no_grad():
        whole = cell.ir(t(x).reshape(-1, 512)).reshape(2, 6, -1)[:, 0]
        step = cell.ir(t(x)[:, 0])
    assert float((whole - step).abs().max()) > 0.1


@pytest.mark.parametrize("model", ["RawNet2", "RawNet2_custom"])
def test_dynamic_int8_of_the_gru_models_matches_jax(model):
    torch.set_num_threads(2)
    jm, tm, v, x = _pair(model, "vlsp_rawnet2.yaml")
    x = x[:2]
    ref = np.asarray(jquant.int8_apply(jm, v, jnp.asarray(x)))
    got = tquant.int8_apply(tm, t(x)).numpy()
    float_ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    to_jax = _cos(got, ref)
    assert to_jax.min() >= 0.995, to_jax
    assert np.all(1 - to_jax < 1 - _cos(ref, float_ref)), to_jax
    # the input products are int8 where the JAX predicate passes:
    # RawNet2Custom's GRU reads 512 channels (K 512), RawNet2's 256
    cell = tquant.quantize_model(copy.deepcopy(tm)).backbone.GRUCell_0
    assert isinstance(cell.hr, tquant.QuantLinear)
    assert isinstance(cell.ir, tquant.QuantLinear) == (model != "RawNet2")


@pytest.mark.parametrize("model", ["RawNet2", "RawNet2_custom"])
def test_gru_calibration_fails_in_jax_and_is_refused_in_the_port(model):
    jm, tm, v, x = _pair(model, "vlsp_rawnet2.yaml")
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jquant.calibrate_act_scales(jm, v, jnp.asarray(x[:1]))
    with pytest.raises(NotImplementedError,
                       match=r"GRU \(backbone/GRUCell_0\).*nn\.RNN's scan"):
        tquant.calibrate_act_scales(tm, t(x[:1]))
    # at floors that leave the GRU float, both calibrate
    cfg = dict(min_k=2048)
    jscales = jquant.calibrate_act_scales(
        jm, v, jnp.asarray(x[:1]), config=jquant.QuantConfig(**cfg))
    got = tquant.calibrate_act_scales(tm, t(x[:1]),
                                      config=tquant.QuantConfig(**cfg))
    assert set(got) == set(jscales)
