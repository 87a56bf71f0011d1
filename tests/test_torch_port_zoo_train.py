"""The ResNetSE, SE-ResNet and TitaNet families and the ``hybrids2``
models in training, port against the JAX package (CPU).

The two packages' random streams differ, so TitaNet's dropout is off on
both sides in these tests alone (flax's ``nn.Dropout`` patched to the
identity, the port's ``Dropout`` modules at rate 0, as the Conformer's
tests do); everything else runs in training mode: the loss, every
gradient leaf and the BatchNorm running statistics the forward updates.

* ``ResNetSE34V2`` (full width) and ``TitaNet`` (size S, one mega block)
  with AAmSoftmaxAP through ``encoder_from_hparams``, 4 speakers × 2
  crops of 0.5 s at 16 kHz, 40 mels;
* ``SEResNet``, ``Res_ECAPA``, ``Tita_ECAPA`` and ``Raw_tita`` at small
  widths, the backbone alone under a fixed linear read-out of its
  embeddings as the loss.

In training mode the 2-D trunks are ill-conditioned in fp32: their
train-mode BatchNorms normalize by the batch's statistics over deep
stacks, so the fp32 gradients of either package sit up to 1.3e-2
(ResNetSE34V2) and 7.2e-2 (Res_ECAPA) of a leaf's largest value from a
float64 run, and JAX's ``Raw_tita`` raw-branch leaves up to 0.17 (the
sinc front, as RawNet3's in ``test_torch_port_train_raw3.py``). So, as
those tests do, every model is measured from the port's own float64 run
(``.double()``, the frontend's fp32 features shared) and held to it, and
to JAX through it:

* the loss within 1e-4 relative of the reference (measured 3.5e-5 at
  worst, ``Raw_tita``'s read-out);
* the BatchNorm statistics within 1e-4 of each tensor's largest value
  (measured 1.1e-5);
* the whole gradient within 2e-3 relative L2 distance (measured 9.5e-4,
  ResNetSE34V2; JAX's fp32 6.6e-4 there and 7.3e-3 for Res_ECAPA), and
  no leaf farther than 5e-3 (measured 3.3e-3; JAX's up to 0.15);
* the port's whole gradient at cosine >= 0.9999 to JAX's;
* leaves zero by construction (the float64 gradient within 1e-10 of the
  model's largest: a bias before a train-mode BatchNorm or under a
  softmax over time) within 1e-5 of the largest on both sides.

bf16, as the Conformer's: the port's distance from JAX's fp32 gradient
at most 1.5 × JAX bf16's own, the two bf16 gradients no farther apart
than 1.5 × JAX bf16's distance from fp32 (ResNetSE34V2's bf16 gradient
sits at cosine 0.93 to fp32 in both packages, measured), the losses
within 2e-2. Dropout's contract (masks from the given generator) is held
for TitaNet and the hybrids that carry it.
"""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu import builder as JB
from speakerverification_tpu.models import ecapa_tdnn as JE
from speakerverification_tpu.models import hybrids2 as JH
from speakerverification_tpu.models import rawnet2_custom as JRC
from speakerverification_tpu.models import senet as JS
from speakerverification_tpu.models import titanet as JT
from speakerverification_tpu.ops import frontend as jf
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.models import ecapa_tdnn as TE
from speakerverification_tpu_torch.models import hybrids2 as TH
from speakerverification_tpu_torch.models import rawnet2_custom as TRC
from speakerverification_tpu_torch.models import senet as TS
from speakerverification_tpu_torch.models import titanet as TT
from speakerverification_tpu_torch.models.layers import Dropout
from speakerverification_tpu_torch.ops import frontend as tf
from speakerverification_tpu_torch.training.state import (
    create_train_state,
    model_state,
)
from speakerverification_tpu_torch.training.train_step import make_train_step
from speakerverification_tpu_torch.weights import params_from_jax, params_to_jax

from test_torch_port_conformer_train import _NoDropout, no_dropout
from test_torch_port_helpers import randomized_variables

SR, SAMPLES = 16000, 8000
MODELS = {
    "ResNetSE34V2": {"name": "ResNetSE34V2", "nOut": 32},
    "TitaNet": {"name": "TitaNet", "nOut": 32, "model_size": "s",
                "n_mega_blocks": 1},
}


def hparams(model: str, **extra) -> dict:
    return {"seed": 0, "audio_spec": {"sample_rate": SR,
                                      "sentence_len": SAMPLES / SR},
            "features": "melspectrogram", "n_mels": 40,
            "frontend_backend": "xla",
            "model": {**MODELS[model], "feature_type": "melspectrogram"},
            "criterion": {"name": "AAmSoftmaxAP", "margin": 0.2,
                          "scale": 30},
            "nClasses": 50, "lr": 0.003,
            "optimizer": {"name": "AdaBelief", "weight_decay": 2e-5,
                          "lr_decay": 0.95}, **extra}


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.normal(0, 1, (4, 2, SAMPLES))).astype(np.float32)
    label = rng.permutation(50)[:4].astype(np.int32)
    return wave, label


def _jax_loss_grads(loss_of, params, stats, dtype=None):
    def fn(p):
        if dtype is not None:
            p = jax.tree.map(lambda a: a.astype(dtype), p)
        loss, mutated = loss_of({"params": p, "batch_stats": stats})
        return loss.astype(jnp.float32), mutated["batch_stats"]
    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        fn, has_aux=True))(params)
    return float(loss), flatten_dict(jax.tree.map(np.asarray, grads)), \
        flatten_dict(jax.tree.map(np.asarray, new_stats))


def _port_loss_grads(tm, loss_of, dtype=None, reference=False):
    """Loss, gradient leaves and statistics of ``tm`` in training mode,
    as flax trees; ``reference``: ``tm`` is a float64 copy, fed float64
    input."""
    tm.train()
    loss_of = functools.partial(loss_of, reference=reference)
    params, _ = model_state(tm)
    names = list(params)
    masters = [params[k] for k in names]
    if dtype is None:
        loss = loss_of(tm, None)
    else:
        loss = loss_of(tm, {k: p.to(dtype) for k, p in zip(names, masters)})
    grads = torch.autograd.grad(loss.float(), masters, allow_unused=True)
    state = {k: v.detach() for k, v in tm.state_dict().items()}
    grad_state = {**state, **{k: (torch.zeros_like(p) if g is None else g)
                              for k, p, g in zip(names, masters, grads)}}
    g_params, _ = params_to_jax(grad_state)
    _, stats = params_to_jax(state)
    return float(loss.detach()), flatten_dict(g_params), flatten_dict(stats)


def _cos(a: dict, b: dict, keys) -> float:
    x = np.concatenate([a[k].ravel() for k in keys]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in keys]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def _rel_l2(a: dict, ref: dict, keys) -> float:
    num = sum(float(np.sum((a[k].astype(np.float64) - ref[k]) ** 2))
              for k in keys)
    return (num / sum(float(np.sum(ref[k] ** 2)) for k in keys)) ** 0.5


def _check(jax_out, tm, port_loss) -> None:
    """The port in fp32 and JAX against the port's float64 run."""
    jl, jg, js = jax_out
    tl, tg, ts = _port_loss_grads(copy.deepcopy(tm), port_loss)
    dl, dg, ds = _port_loss_grads(copy.deepcopy(tm).double(), port_loss,
                                  reference=True)
    assert set(tg) == set(jg) == set(dg) and set(ts) == set(js) == set(ds)
    assert abs(tl - dl) <= 1e-4 * abs(dl) and abs(jl - dl) <= 1e-3 * abs(dl)
    for k, ref in ds.items():
        top = float(np.abs(ref).max())
        assert float(np.abs(ts[k] - ref).max()) <= 1e-4 * top, k
        assert float(np.abs(js[k] - ref).max()) <= 1e-4 * top, k
    top = max(float(np.abs(g).max()) for g in dg.values())
    zero = [k for k in dg if float(np.abs(dg[k]).max()) <= 1e-10 * top]
    for k in zero:
        assert max(np.abs(jg[k]).max(), np.abs(tg[k]).max()) <= 1e-5 * top, k
    live = sorted(set(dg) - set(zero))
    assert _rel_l2(tg, dg, live) <= 2e-3
    worst = max(_rel_l2(tg, dg, [k]) for k in live)
    assert worst <= 5e-3, worst
    assert _cos(tg, jg, live) >= 0.9999


def _encoder_pair(model: str, **extra):
    h = hparams(model, **extra)
    wave, label = _batch()
    jm = JB.encoder_from_hparams(h, with_loss=True, num_devices=1)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)},
                         jnp.asarray(wave), jnp.asarray(label))
    v = randomized_variables(v, seed=1)
    tm = TB.encoder_from_hparams(h, with_loss=True)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm))
    no_dropout(tm)

    def jax_loss(variables):
        (loss, _), mutated = jm.apply(
            variables, jnp.asarray(wave), jnp.asarray(label), train=True,
            mutable=["batch_stats"])
        return loss, mutated

    def port_loss(module, cast, reference=False):
        w = torch.from_numpy(wave)
        args = (w.double() if reference else w, torch.from_numpy(label))
        if cast is None:
            return module(*args)[0]
        return torch.func.functional_call(module, cast, args,
                                          strict=False)[0]
    return jm, tm, v, jax_loss, port_loss


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_mode_matches_jax_with_dropout_off(model, monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    torch.set_num_threads(2)
    jm, tm, v, jax_loss, port_loss = _encoder_pair(model)
    _check(_jax_loss_grads(jax_loss, v["params"], v["batch_stats"]), tm,
           port_loss)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bf16_train_mode_matches_jax_bf16(model, monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    torch.set_num_threads(2)
    jm, tm, v, jax_loss, port_loss = _encoder_pair(model, mixedprec=True)
    _, fg, _ = _jax_loss_grads(jax_loss, v["params"], v["batch_stats"])
    jl, jg, _ = _jax_loss_grads(jax_loss, v["params"], v["batch_stats"],
                                jnp.bfloat16)
    tl, tg, _ = _port_loss_grads(tm, port_loss, torch.bfloat16)
    assert tl == pytest.approx(jl, rel=2e-2)
    keys = sorted(jg)
    jax_off = 1 - _cos(jg, fg, keys)
    assert 1 - _cos(tg, fg, keys) <= 1.5 * jax_off
    assert 1 - _cos(tg, jg, keys) <= 1.5 * jax_off


def _small_ecapa(jax_side: bool, n_mels: int):
    kw = dict(lin_neurons=16, channels=(32, 32, 32, 32, 96),
              res2net_scale=4, se_channels=8, attention_channels=8,
              log_input=False, input_norm=True)
    return JE.ECAPA_TDNN(**kw) if jax_side else TE.ECAPA_TDNN(n_mels=n_mels,
                                                              **kw)


def _small_titanet(jax_side: bool, n_mels: int):
    kw = dict(nOut=16, hidden_size=32, mega_block_kernel=7, n_mega_blocks=2,
              encoder_output_size=48, attention_hidden_size=8)
    return JT.TitaNet(**kw) if jax_side else TT.TitaNet(n_mels=n_mels, **kw)


def _small_raw(jax_side: bool):
    kw = dict(nOut=16, layers=(1, 1), filters=(8, 16), front_proc="sinc",
              aggregate="asp", att_dim=8, first_conv_size=31)
    return (JRC.RawNet2Custom(**kw) if jax_side
            else TRC.RawNet2Custom(n_samples=SAMPLES, **kw))


def _backbones(name: str):
    """(JAX module, port module, input) at small widths."""
    cfg = dict(sample_rate=SR, win_length=400, hop_length=160, n_mels=40)
    jcfg, tcfg = jf.FrontendConfig(**cfg), tf.FrontendConfig(**cfg)
    rng = np.random.default_rng(3)
    wave = (0.1 * rng.normal(0, 1, (4, SAMPLES))).astype(np.float32)
    mel = ((rng.normal(0.5, 0.2, (4, 51, 40))) ** 2).astype(np.float32)
    if name == "SEResNet":
        return (JS.SEResNet(nOut=16, layers=(1, 1)),
                TS.SEResNet(nOut=16, layers=(1, 1)), mel)
    if name == "Res_ECAPA":
        ch = (32, 32, 32, 32, 96)
        return (JH.ResECAPA(nOut=16, ecapa_channels=ch),
                TH.ResECAPA(n_mels=40, nOut=16, ecapa_channels=ch), mel)
    if name == "Tita_ECAPA":
        return (JH.TitaECAPA(ecapa=_small_ecapa(True, 40),
                             titanet=_small_titanet(True, 40), frontend=jcfg),
                TH.TitaECAPA(ecapa=_small_ecapa(False, 40),
                             titanet=_small_titanet(False, 40),
                             frontend=tcfg, frontend_backend="xla"), wave)
    assert name == "Raw_tita"
    return (JH.RawTita(titanet=_small_titanet(True, 40),
                       raw_branch=_small_raw(True), frontend=jcfg),
            TH.RawTita(titanet=_small_titanet(False, 40),
                       raw_branch=_small_raw(False), frontend=tcfg,
                       frontend_backend="xla"), wave)


BACKBONES = ("Raw_tita", "Res_ECAPA", "SEResNet", "Tita_ECAPA")


@pytest.mark.parametrize("name", BACKBONES)
def test_backbone_train_mode_matches_jax(name, monkeypatch):
    """The backbone alone in training mode under a fixed read-out of its
    embeddings, ``sum(emb · R)``."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    torch.set_num_threads(2)
    jm, tm, x = _backbones(name)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x))
    v = randomized_variables(v, seed=2)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"],
                                       like=tm))
    no_dropout(tm)
    with torch.no_grad():
        width = tm.eval()(torch.from_numpy(x)).shape[-1]
    read = np.random.default_rng(4).normal(0, 1, (4, width)).astype(
        np.float32)

    def jax_loss(variables):
        out, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * read), mutated

    def port_loss(module, cast, reference=False):
        assert cast is None
        dt = torch.float64 if reference else torch.float32
        return torch.sum(module(torch.from_numpy(x).to(dt))
                         * torch.from_numpy(read).to(dt))
    _check(_jax_loss_grads(jax_loss, v["params"], v["batch_stats"]), tm,
           port_loss)


def test_titanet_forward_draws_its_dropout_from_its_generator():
    torch.set_num_threads(2)
    tm = TB.encoder_from_hparams(hparams("TitaNet"), with_loss=True)
    wave, label = (torch.from_numpy(x) for x in _batch())
    assert sum(isinstance(m, Dropout) and m.rate == 0.5
               for m in tm.modules()) == 4      # 3 sub-blocks + the block
    tm.train()
    with pytest.raises(ValueError, match="Generator"):
        tm(wave, label)
    state = torch.random.get_rng_state()
    with torch.no_grad():
        l1, _ = tm(wave, label, rng=torch.Generator().manual_seed(0))
        l2, _ = tm(wave, label, rng=torch.Generator().manual_seed(0))
        l3, _ = tm(wave, label, rng=torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert float(l1) == float(l2) != float(l3)
    tm.eval()
    with torch.no_grad():
        assert torch.equal(tm(wave[:, 0]), tm(wave[:, 0]))


@pytest.mark.parametrize("name", ["Tita_ECAPA", "Raw_tita"])
def test_hybrids_hand_their_generator_to_titanet(name):
    torch.set_num_threads(2)
    _, tm, x = _backbones(name)
    x = torch.from_numpy(x)
    tm.train()
    with pytest.raises(ValueError, match="Generator"):
        tm(x)
    with torch.no_grad():
        a = tm(x, torch.Generator().manual_seed(0))
        b = tm(x, torch.Generator().manual_seed(0))
        c = tm(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_step_with_titanet_needs_and_uses_a_generator():
    torch.set_num_threads(2)
    h = hparams("TitaNet")
    wave, label = (torch.from_numpy(x) for x in _batch())
    runs = []
    for seed in (0, 0, 1):
        model = TB.encoder_from_hparams(h, with_loss=True)
        tx = TB.optimizer_from_hparams(h)
        state = create_train_state(model, tx, 5)
        step = make_train_step(model, tx)
        if not runs:
            with pytest.raises(ValueError, match="Generator"):
                step(state, wave, label, 0.003)
        state, m = step(state, wave, label, 0.003,
                        torch.Generator().manual_seed(seed))
        runs.append((float(m["loss"]), {k: p.detach().clone()
                                        for k, p in state.params.items()}))
    assert runs[0][0] == runs[1][0] != runs[2][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
