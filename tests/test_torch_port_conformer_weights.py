"""The Conformer family's weights, checkpoints and int8 path, port against
the JAX package (CPU).

* ``params_to_jax`` / ``params_from_jax`` carry both models bit for bit
  in both directions (full width from the port's seeded init, and a JAX
  init through the port and back), and the port's tree has the names
  and shapes of JAX's (``jax.eval_shape``, nothing compiled).
* ``init_weights_`` draws the Conv2d, depthwise, LayerNorm and
  ``u_bias``/``v_bias`` leaves from flax's distributions.
* A JAX-written msgpack train state (best weights and EMA) serves in the
  port's engine; a state the port's step and ``CheckpointManager`` write
  (optimizer and EMA included) restores as the JAX package's own.
* int8: the calibration scales under JAX's keys and the int8 embeddings
  against JAX int8, at the default floors (encoder dim 128: three
  Denses) and at floors that quantize every eligible layer; the
  depthwise conv and the Conv2d stay float on both sides.

Tolerances: weights bit for bit; engine embeddings 1e-4 of the largest
magnitude; scales 1e-5 relative; int8 embeddings cosine ≥ 0.9999 to JAX
int8 per row, and closer to JAX int8 than JAX int8 is to float.
"""

import json

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu import builder as JB
from speakerverification_tpu import quant as jquant
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu.models import conformer as JC
from speakerverification_tpu.optim import track_ema
from speakerverification_tpu.training import checkpoint as jckpt
from speakerverification_tpu.training.state import (
    create_train_state as j_create_train_state,
)
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch import quant as tquant
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.models import conformer as TC
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.weights import (
    act_scales_from_jax,
    init_weights_,
    params_from_jax,
    params_to_jax,
)

from test_torch_port_helpers import randomized_variables, t
from test_torch_port_train_helpers import Pair, batches

SR = 16000


def _waves(n: int, samples: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, samples))
            ).astype(np.float32)


def _hparams(model: dict, **extra) -> dict:
    return {"seed": 0, "num_eval": 2,
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "frontend_backend": "xla",
            "model": {"feature_type": "melspectrogram", **model},
            "criterion": {"name": "AAmSoftmaxAP", "margin": 0.2,
                          "scale": 30}, "nClasses": 12, **extra}


CONFORMER_SMALL = {"name": "Conformer", "nOut": 16, "encoder_dim": 32,
                   "num_layers": 1}


@pytest.mark.parametrize("name", ["Conformer", "ECAPA_Conformer"])
def test_full_width_round_trip_bit_for_bit(name):
    torch.set_num_threads(2)
    model = TB.build_model(name, n_mels=80)
    init_weights_(model, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=gen))
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
    sd = model.state_dict()
    params, stats = params_to_jax(sd)
    back = params_from_jax(params, stats, like=model)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # the JAX init of the same model, traced for its shapes only
    jm = (JC.ConformerSpeaker() if name == "Conformer"
          else JC.ECAPAConformer())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 201, 80)))
    for col, tree in (("params", params), ("batch_stats", stats)):
        want = {k: tuple(v.shape)
                for k, v in flatten_dict(shapes[col]).items()}
        got = {k: tuple(v.shape) for k, v in flatten_dict(tree).items()}
        assert got == want, sorted(set(got) ^ set(want))[:6]


def test_jax_init_through_the_port_and_back():
    x = np.abs(_waves(2, 40 * 41, seed=0)).reshape(2, 41, 40)
    for jm, tm in ((JC.ConformerSpeaker(nOut=16, encoder_dim=32,
                                        num_layers=2),
                    TC.ConformerSpeaker(n_mels=40, nOut=16, encoder_dim=32,
                                        num_layers=2)),
                   (JC.ECAPAConformer(nOut=8, channels=(16, 16, 16, 16, 48),
                                      res2net_scale=4, se_channels=8,
                                      attention_channels=8, encoder_dim=16,
                                      num_layers=1),
                    TC.ECAPAConformer(n_mels=40, nOut=8,
                                      channels=(16, 16, 16, 16, 48),
                                      res2net_scale=4, se_channels=8,
                                      attention_channels=8, encoder_dim=16,
                                      num_layers=1))):
        v = randomized_variables(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)), seed=3)
        tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                           like=tm))
        params, stats = params_to_jax(tm.state_dict())
        for col, tree in (("params", params), ("batch_stats", stats)):
            want = flatten_dict(v[col])
            got = flatten_dict(tree)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def _std_within(w: torch.Tensor, want: float, rel: float) -> None:
    got = float(w.detach().double().std())
    assert abs(got - want) <= rel * want, (got, want)


def test_init_weights_draws_as_flax():
    torch.set_num_threads(2)
    model = TB.build_model("ECAPA_Conformer", n_mels=80)
    init_weights_(model, torch.Generator().manual_seed(0))
    enc = model.ConformerEncoder_0
    # Conv2d: lecun_normal over kh·kw·in
    _std_within(enc.Conv_1.weight, (9 * 144) ** -0.5, 0.02)
    _std_within(enc.Conv_0.weight, 9 ** -0.5, 0.1)
    assert not enc.Conv_0.bias.any()
    blk = enc.ConformerBlock_0
    # the depthwise conv: fan_in is its taps
    _std_within(blk._ConvModule_0.Conv_0.weight, 31 ** -0.5, 0.05)
    ln = blk.LayerNorm_0
    assert torch.equal(ln.weight, torch.ones(144)) and not ln.bias.any()
    # u_bias / v_bias: xavier_uniform over (H, Dh) = (4, 36)
    att = blk.MHSAModule_0.RelativeMultiHeadAttention_0
    limit = (6 / (4 + 36)) ** 0.5
    for w in (att.u_bias, att.v_bias):
        assert float(w.detach().abs().max()) <= limit
        _std_within(w, limit / 3 ** 0.5, 0.15)
    assert not torch.equal(att.u_bias, att.v_bias)
    # and against JAX's own draw of the same Conv2d
    jv = jax.jit(JC.ECAPAConformer(channels=(16, 16, 16, 16, 48),
                                   encoder_dim=144, num_layers=1).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 40, 80)))
    jw = np.asarray(jv["params"]["ConformerEncoder_0"]["Conv_1"]["kernel"])
    _std_within(enc.Conv_1.weight, float(jw.std()), 0.03)


def test_engine_from_a_jax_checkpoint_embeds_like_jax(tmp_path):
    h = _hparams(CONFORMER_SMALL, save_folder=str(tmp_path / "save"))
    jm = JB.encoder_from_hparams(h, with_loss=True, num_devices=1)
    wave = _waves(4, 8000, seed=1).reshape(2, 2, 8000)
    state = j_create_train_state(jm, JB.optimizer_from_hparams(h),
                                 jax.random.PRNGKey(0), jnp.asarray(wave),
                                 jnp.asarray([1, 3], jnp.int32))
    state = state.replace(batch_stats=randomized_variables(
        {"batch_stats": state.batch_stats}, seed=2)["batch_stats"])
    rng = np.random.default_rng(4)
    ema = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), state.params)
    tx = optax.chain(optax.adam(1e-3), track_ema(0.9))
    opt = tx.init(state.params)
    mdir = JEngine(h).dirs["model"]
    jckpt.save_checkpoint(mdir / "best_state.msgpack", state.replace(
        opt_state=(opt[0], opt[1]._replace(ema=ema))))
    waves = _waves(3, 8000, seed=5)
    for use_ema in (False, True):
        hh = {**h, "use_ema": use_ema}
        ref = np.asarray(JEngine(hh).embed_fn(waves))
        got = InferenceEngine(hh, device="cpu").embed_fn(waves).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_port_written_state_restores_in_jax(tmp_path):
    torch.set_num_threads(2)
    h = _hparams(CONFORMER_SMALL, lr=0.003,
                 optimizer={"name": "AdaBelief", "weight_decay": 2e-5,
                            "lr_decay": 0.95, "ema_decay": 0.99})
    data = batches(np.random.default_rng(0), 2, 3, 2, 8000, 12)
    pair = Pair(h, data[0])
    pair.load_jax_state(tmp_path)
    for i, (wave, label) in enumerate(data):
        pair.tstate, _ = pair.tstep(pair.tstate, torch.from_numpy(wave),
                                    torch.from_numpy(label), 0.003,
                                    torch.Generator().manual_seed(i))
    mgr = tckpt.CheckpointManager(tmp_path / "run")
    mgr.save_epoch(pair.tstate, 1, loss=3.0, lr=0.003)
    path = tmp_path / "run" / "best_state.msgpack"
    assert json.loads((tmp_path / "run" / "best_state.msgpack.json")
                      .read_text())["step"] == 2
    restored = jckpt.load_checkpoint(path, pair.jstate)
    assert int(restored.step) == 2
    got = flatten_dict(fser.msgpack_restore(fser.to_bytes(restored)))
    want = flatten_dict(fser.msgpack_restore(path.read_bytes()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    # the EMA moved away from the weights, and the weights as the port has
    # them
    ema = flatten_dict(restored.opt_state[1].ema)
    params, _ = params_to_jax(pair.tmodel.state_dict())
    params = flatten_dict(params)
    assert set(ema) == set(params)
    key = ("backbone", "ConformerEncoder_0", "ConformerBlock_0",
           "MHSAModule_0", "RelativeMultiHeadAttention_0", "u_bias")
    np.testing.assert_array_equal(np.asarray(flatten_dict(
        restored.params)[key]), params[key])
    assert not np.array_equal(np.asarray(ema[key]), params[key])


SMALL_FLOORS = dict(min_k=16, min_n=8)
INT8_MODEL = {"name": "Conformer", "nOut": 24, "encoder_dim": 128,
              "num_layers": 1}


@pytest.fixture(scope="module")
def int8_pair():
    h = _hparams(INT8_MODEL, n_mels=80)
    x = _waves(4, 8000, seed=7)
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    v = randomized_variables(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x)), seed=0)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm))
    tm.eval()
    return jm, tm, v, x


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("floors", ["default", "small"])
def test_int8_scales_and_embeddings_match_jax(int8_pair, floors):
    jm, tm, v, x = int8_pair
    kw = SMALL_FLOORS if floors == "small" else {}
    jscales = jquant.calibrate_act_scales(
        jm, v, jnp.asarray(x[:2]), config=jquant.QuantConfig(**kw))
    got = tquant.calibrate_act_scales(tm, t(x[:2]),
                                      config=tquant.QuantConfig(**kw))
    if floors == "default":
        assert sorted(got) == [
            "backbone/ConformerEncoder_0/ConformerBlock_0/_FeedForward_0/"
            "Dense_1",
            "backbone/ConformerEncoder_0/ConformerBlock_0/_FeedForward_1/"
            "Dense_1",
            "backbone/ConformerEncoder_0/Dense_0"]
    else:
        # every Dense (the bias-free positional one on the encoding) and
        # the pooling's 1x1 convs; never the depthwise conv or a Conv2d
        assert len(got) > 10
        assert not any(k.endswith(("_ConvModule_0/Conv_0",
                                   "ConformerEncoder_0/Conv_0",
                                   "ConformerEncoder_0/Conv_1"))
                       for k in got)
    assert set(got) == set(jscales)
    for k, val in got.items():
        assert val == pytest.approx(jscales[k], rel=1e-5), k
    scales = act_scales_from_jax(jscales, tm, tquant.QuantConfig(**kw))
    ref = np.asarray(jquant.make_int8_embed_fn(
        jm, config=jquant.QuantConfig(**kw), act_scales=jscales)(
        v["params"], v["batch_stats"], jnp.asarray(x)))
    emb = tquant.make_int8_embed_fn(tm, config=tquant.QuantConfig(**kw),
                                    act_scales=scales)(t(x)).numpy()
    float_ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    to_jax = _cos(emb, ref)
    assert to_jax.min() >= 0.9999, to_jax
    assert np.all(1 - to_jax < 1 - _cos(ref, float_ref)), to_jax
