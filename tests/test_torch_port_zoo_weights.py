"""The zoo's weights, checkpoints and int8 path, port against the JAX
package (CPU): the ResNetSE, SE-ResNet and TitaNet families, ``Tita_ECAPA``,
``Raw_tita`` and ``Res_ECAPA``.

* ``params_to_jax`` / ``params_from_jax`` carry each model bit for bit
  in both directions: full width from the port's seeded init (strided
  Conv2d, depthwise conv kernels ``[k, 1, C]`` ↔ ``[C, 1, k]``, the SE
  layers with and without bias, ``inorm_scale``/``inorm_bias``, the
  BatchNorm statistics of every module; ``test_torch_port_yamls.py``
  holds every tree's names and shapes to JAX's), and a JAX init through
  the port and back; a leaf left over or missing raises.
* ``init_weights_`` draws as flax does (lecun_normal over the taps times
  one group's in-channels: the depthwise conv's fan-in is its taps).
* A JAX-written msgpack train state (best weights and EMA) serves in the
  port's engine; a state the port's step and ``CheckpointManager`` write
  restores as the JAX package's own.
* int8: the calibrated layers under JAX's keys at the default floors
  (JAX's counts: ResNetSE34V2 2, ``Conv_1`` and ``Dense_0``; TitaNet-S
  2; Res_ECAPA 13 and Tita_ECAPA 55, each with the ECAPA
  pooling's dead key, a recorded 0.0 the port never calls; the
  depthwise convs and every Conv2d float on both sides), scales within
  1e-5 relative, the int8 embeddings with JAX's scales at cosine >=
  0.9999 per row to JAX int8 and closer to it than JAX int8 is to float.

Tolerances: weights bit for bit; engine embeddings 1e-4 of the largest
magnitude (fp32 forwards of up to ~70 layers).
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
from speakerverification_tpu.optim import track_ema
from speakerverification_tpu.training import checkpoint as jckpt
from speakerverification_tpu.training.state import (
    create_train_state as j_create_train_state,
)
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch import quant as tquant
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.weights import (
    act_scales_from_jax,
    init_weights_,
    params_from_jax,
    params_to_jax,
)

from test_torch_port_helpers import randomized_variables, t
from test_torch_port_train_helpers import Pair, batches
from test_torch_port_zoo import port_pair

SR = 16000


def _waves(n: int, samples: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, samples))
            ).astype(np.float32)


def _hparams(model: dict, samples: int = 8000, **extra) -> dict:
    return {"seed": 0, "num_eval": 2,
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": samples / SR, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 80, "features": "melspectrogram",
            "frontend_backend": "xla",
            "model": {"feature_type": "melspectrogram", **model},
            "criterion": {"name": "AAmSoftmaxAP", "margin": 0.2,
                          "scale": 30}, "nClasses": 12, **extra}


# every model kind at its builder's widths (TitaNet at size S with two mega
# blocks, Raw_tita's crop 9,000 samples), with the features it takes
FULL = {
    "ResNetSE34V2": ({"name": "ResNetSE34V2"}, "melspectrogram", 8000),
    "ResNetSE50": ({"name": "ResNetSE50"}, "melspectrogram", 8000),
    "se_resnet34": ({"name": "se_resnet34"}, "melspectrogram", 8000),
    "TitaNet": ({"name": "TitaNet", "model_size": "s", "n_mega_blocks": 2,
                 "nOut": 192}, "melspectrogram", 8000),
    "Tita_ECAPA": ({"name": "Tita_ECAPA", "nOut": 512}, "raw", 8000),
    "Raw_tita": ({"name": "Raw_tita", "nOut": 512}, "raw", 9000),
    "Res_ECAPA": ({"name": "Res_ECAPA", "nOut": 128}, "melspectrogram",
                  8000),
}


def _full(name: str):
    model, features, samples = FULL[name]
    h = _hparams({**model, "feature_type": features}, samples,
                 features=features)
    return h, samples


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_round_trip_bit_for_bit(name):
    torch.set_num_threads(2)
    h, _ = _full(name)
    model = TB.encoder_from_hparams(h).backbone
    init_weights_(model, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=gen))
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        for k, p in model.named_parameters():
            if k.startswith("inorm_"):
                p.uniform_(0.5, 1.5, generator=gen)
    sd = model.state_dict()
    params, stats = params_to_jax(sd)
    back = params_from_jax(params, stats, like=model)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # a leaf left over, or one missing, raises
    with pytest.raises(KeyError):
        params_from_jax({**params, "stray": {"kernel": np.zeros((2, 2))}},
                        stats, like=model)
    first = sorted(stats)[0]
    with pytest.raises(KeyError):
        params_from_jax(params, {k: v for k, v in stats.items()
                                 if k != first}, like=model)


@pytest.mark.parametrize("name", ["TitaNet", "Res_ECAPA", "ResNetSE34V2"])
def test_jax_init_through_the_port_and_back(name):
    h, samples = _full(name)
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    v = randomized_variables(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(_waves(2, samples, 0))), seed=3)
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
    tita = TB.build_model("TitaNet", nOut=192, n_mels=80)
    init_weights_(tita, torch.Generator().manual_seed(0))
    blk = tita.MegaBlock_0.ConvBlock1d_0
    # the depthwise conv: fan-in is its 11 taps
    _std_within(blk.Conv_0.weight, 11 ** -0.5, 0.05)
    _std_within(blk.Conv_1.weight, 1024 ** -0.5, 0.02)
    assert not blk.Conv_0.bias.any()
    res = TB.build_model("Res_ECAPA", nOut=128, n_mels=80)
    init_weights_(res, torch.Generator().manual_seed(0))
    # Conv2d: lecun_normal over kh·kw·in; the SE's biases zero
    _std_within(res.RootSEBasicBlock_2.Conv_1.weight, (9 * 64) ** -0.5, 0.03)
    assert not res.RootSEBasicBlock_2.SELayer_0.Dense_0.bias.any()
    assert torch.equal(res.inorm_scale, torch.ones(80))
    assert not res.inorm_bias.any()
    # and against JAX's own draw of the same depthwise kernel
    from speakerverification_tpu.models import titanet as JT
    jv = jax.jit(JT.MegaBlock(1024, 11).init)(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 20, 1024)))
    jw = np.asarray(jv["params"]["ConvBlock1d_0"]["Conv_0"]["kernel"])
    assert jw.shape == (11, 1, 1024)
    _std_within(blk.Conv_0.weight, float(jw.std()), 0.05)


TITANET_S = {"name": "TitaNet", "model_size": "s", "n_mega_blocks": 1,
             "nOut": 16}


def test_engine_from_a_jax_checkpoint_embeds_like_jax(tmp_path):
    h = _hparams(TITANET_S, save_folder=str(tmp_path / "save"))
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
    """TitaNet-S trained two steps by the port (dropout drawn from each
    step's generator), written by its ``CheckpointManager``, restored by
    the JAX package whole."""
    torch.set_num_threads(2)
    h = _hparams(TITANET_S, lr=0.003,
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
    key = ("backbone", "MegaBlock_0", "ConvBlock1d_0", "Conv_0", "kernel")
    params, _ = params_to_jax(pair.tmodel.state_dict())
    np.testing.assert_array_equal(np.asarray(flatten_dict(
        restored.params)[key]), flatten_dict(params)[key])
    ema = flatten_dict(restored.opt_state[1].ema)
    assert not np.array_equal(np.asarray(ema[key]), flatten_dict(params)[key])


# the layers JAX's calibration records at the default floors, and one key
INT8 = {
    "ResNetSE34V2": (2, "backbone/Conv_1"),
    "TitaNet": (2, "backbone/Dense_1"),
    "Res_ECAPA": (13, "backbone/ECAPA_TDNN_0/TDNNBlock_1/Conv1d_0/Conv_0"),
    "Tita_ECAPA": (55, "backbone/titanet/MegaBlock_0/ConvBlock1d_0/Conv_1"),
}


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("name", sorted(INT8))
def test_int8_scales_and_embeddings_match_jax(name):
    torch.set_num_threads(2)
    h, samples = _full(name)
    x = _waves(3, samples, seed=7)
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    v = port_pair(tm)
    jscales = jquant.calibrate_act_scales(jm, v, jnp.asarray(x[:2]))
    got = tquant.calibrate_act_scales(tm, t(x[:2]))
    n, key = INT8[name]
    live = {k: s for k, s in jscales.items() if s > 0.0}
    assert len(jscales) == n and set(got) == set(live) and key in got
    assert not any(k.endswith("ConvBlock1d_0/Conv_0") or "Conv2d" in k
                   for k in got)
    for k, val in got.items():
        assert val == pytest.approx(jscales[k], rel=1e-5), k
    scales = act_scales_from_jax(jscales, tm)
    ref = np.asarray(jquant.make_int8_embed_fn(jm, act_scales=jscales)(
        v["params"], v["batch_stats"], jnp.asarray(x)))
    emb = tquant.make_int8_embed_fn(tm, act_scales=scales)(t(x)).numpy()
    float_ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    to_jax = _cos(emb, ref)
    assert to_jax.min() >= 0.9999, to_jax
    assert np.all(1 - to_jax < 1 - _cos(ref, float_ref)), to_jax
