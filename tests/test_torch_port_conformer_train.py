"""The Conformer family in training, port against the JAX package (CPU).

The random streams of the two packages differ, so dropout can never
match bit for bit: the parity tests switch it off on both sides in the
test alone (flax's ``nn.Dropout`` patched to the identity for the JAX
module; the port's ``Dropout`` modules at rate 0) and hold everything
else in training mode against JAX: the loss, every gradient and the
BatchNorm running statistics the forward updates. The dropout's own
contract is held apart: masks drawn from the generator the forward is
given, the same generator giving the same mask, a kept share near 0.9
scaled by 1/0.9, a raise without a generator, and torch's global RNG
left alone.

A small ``Conformer`` (dim 64, two blocks) and ``ECAPAConformer`` (the
JAX test's small width) with AAmSoftmaxAP, as ``yaml/model_plot.yaml``
trains, on 4 speakers × 2 crops of 0.5 s at 16 kHz. Tolerances: fp32
loss 1e-5 relative, every gradient leaf within 3e-4 of its largest
magnitude (the SE-Res2Net trunk's smallest leaves differ by 0.8–1.4e-4
with the thread count alone, measured; those zero by construction within 1e-5 of the model's
largest gradient) and the statistics 1e-5 of theirs; bf16 (parameters
cast as the train step casts them) as its test says.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu import builder as JB
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.models import conformer as TC
from speakerverification_tpu_torch.training.state import (
    create_train_state,
    model_state,
)
from speakerverification_tpu_torch.training.train_step import make_train_step
from speakerverification_tpu_torch.weights import params_from_jax, params_to_jax

from test_torch_port_helpers import randomized_variables

SR, SAMPLES = 16000, 8000
SMALL = {
    "Conformer": {"name": "Conformer", "nOut": 32, "encoder_dim": 64,
                  "num_layers": 2},
    "ECAPA_Conformer": {"name": "ECAPA_Conformer", "nOut": 24,
                        "channels": [32, 32, 32, 32, 96],
                        "encoder_dim": 32, "num_layers": 2},
}


def hparams(model: str, **extra) -> dict:
    return {"seed": 0, "audio_spec": {"sample_rate": SR,
                                      "sentence_len": SAMPLES / SR},
            "features": "melspectrogram", "n_mels": 40,
            "frontend_backend": "xla",
            "model": {**SMALL[model], "feature_type": "melspectrogram"},
            "criterion": {"name": "AAmSoftmaxAP", "margin": 0.2,
                          "scale": 30},
            "nClasses": 50, "lr": 0.003,
            "optimizer": {"name": "AdaBelief", "weight_decay": 2e-5,
                          "lr_decay": 0.95}, **extra}


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def no_dropout(model: torch.nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, TC.Dropout):
            m.rate = 0.0


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.normal(0, 1, (4, 2, SAMPLES))).astype(np.float32)
    label = rng.permutation(50)[:4].astype(np.int32)
    return wave, label


def _pair(model: str, **extra):
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
    return h, jm, tm, v, wave, label


def _jax_loss_grads(jm, v, wave, label, dtype=None):
    def loss_fn(params):
        if dtype is not None:
            params = jax.tree.map(lambda p: p.astype(dtype), params)
        (loss, _), mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(wave), jnp.asarray(label), train=True,
            mutable=["batch_stats"])
        return loss.astype(jnp.float32), mutated["batch_stats"]
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    return float(loss), flatten_dict(jax.tree.map(np.asarray, grads)), \
        flatten_dict(jax.tree.map(np.asarray, stats))


def _port_loss_grads(tm, wave, label, dtype=None):
    tm.train()
    params, _ = model_state(tm)
    names = list(params)
    masters = [params[k] for k in names]
    if dtype is None:
        loss, _ = tm(torch.from_numpy(wave), torch.from_numpy(label))
    else:
        cast = {k: p.to(dtype) for k, p in zip(names, masters)}
        loss, _ = torch.func.functional_call(
            tm, cast, (torch.from_numpy(wave), torch.from_numpy(label)),
            strict=False)
    grads = torch.autograd.grad(loss.float(), masters, allow_unused=True)
    state = {k: v.detach() for k, v in tm.state_dict().items()}
    grad_state = {**state, **{k: (torch.zeros_like(p) if g is None else g)
                              for k, p, g in zip(names, masters, grads)}}
    g_params, _ = params_to_jax(grad_state)
    _, stats = params_to_jax(state)
    return float(loss.detach()), flatten_dict(g_params), flatten_dict(stats)


# gradients that are zero by construction (a softmax ignores a shift of
# all its inputs: the attention's key bias, the pooling convs' biases
# and the BatchNorm bias before the Conformer's pooling conv,
# AngularProto's logit bias): both sides give rounding noise, held to
# 1e-5 of the largest gradient of the model
ZERO_GRAD = ("RelativeMultiHeadAttention_0/Dense_1/bias",
             "backbone/Conv_1/bias", "backbone/BatchNorm_0/bias",
             "AttentiveStatisticsPooling_0/Conv1d_0/Conv_0/bias",
             "AngularProto_0/b")


def _cos(a: dict, b: dict, keys) -> float:
    x = np.concatenate([a[k].ravel() for k in keys]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in keys]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


@pytest.mark.parametrize("model", ["Conformer", "ECAPA_Conformer"])
def test_train_mode_matches_jax_with_dropout_off(model, monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    torch.set_num_threads(2)
    h, jm, tm, v, wave, label = _pair(model)
    no_dropout(tm)
    jl, jg, js = _jax_loss_grads(jm, v, wave, label)
    tl, tg, ts = _port_loss_grads(tm, wave, label)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert set(tg) == set(jg)
    top = max(float(np.abs(g).max()) for g in jg.values())
    for k, ref in jg.items():
        name = "/".join(k)
        if name.endswith(ZERO_GRAD):
            assert max(np.abs(ref).max(), np.abs(tg[k]).max()) <= 1e-5 * top
            continue
        err = float(np.abs(tg[k] - ref).max())
        assert err <= 3e-4 * float(np.abs(ref).max()), name
    assert set(ts) == set(js)
    for k, ref in js.items():
        err = float(np.abs(ts[k] - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()), ("/".join(k), err)


@pytest.mark.parametrize("model", ["Conformer", "ECAPA_Conformer"])
def test_bf16_train_mode_matches_jax_bf16(model, monkeypatch):
    """bf16 rounding moves a training-mode gradient far in both packages
    (ECAPAConformer's whole gradient sits at cosine ~0.90 to the fp32
    one in each, measured): the port's distance from JAX's fp32 gradient
    is held to 1.5 × JAX's own, and the two bf16 gradients to each other
    at cosine ≥ 0.95; the losses agree within 2e-2."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    torch.set_num_threads(2)
    h, jm, tm, v, wave, label = _pair(model, mixedprec=True)
    no_dropout(tm)
    _, fg, _ = _jax_loss_grads(jm, v, wave, label)
    jl, jg, _ = _jax_loss_grads(jm, v, wave, label, jnp.bfloat16)
    tl, tg, _ = _port_loss_grads(tm, wave, label, torch.bfloat16)
    assert tl == pytest.approx(jl, rel=2e-2)
    keys = sorted(jg)
    assert 1 - _cos(tg, fg, keys) <= 1.5 * (1 - _cos(jg, fg, keys))
    assert _cos(tg, jg, keys) >= 0.95


def test_dropout_contract():
    drop = TC.Dropout(0.1).train()
    x = torch.ones(200, 500)
    a = drop(x, torch.Generator().manual_seed(3))
    b = drop(x, torch.Generator().manual_seed(3))
    c = drop(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.9),
                               rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="Generator"):
        drop(x, None)
    # off in eval and at rate 0, where no generator is needed
    assert torch.equal(drop.eval()(x, None), x)
    assert torch.equal(TC.Dropout(0.0).train()(x, None), x)


@pytest.mark.parametrize("model", ["Conformer", "ECAPA_Conformer"])
def test_training_forward_draws_from_its_generator(model):
    torch.set_num_threads(2)
    tm = TB.encoder_from_hparams(hparams(model), with_loss=True)
    wave, label = (torch.from_numpy(x) for x in _batch())
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
        e1 = tm(wave[:, 0])
        e2 = tm(wave[:, 0])
    assert torch.equal(e1, e2)


def test_train_step_with_dropout_needs_and_uses_a_generator():
    torch.set_num_threads(2)
    h = hparams("Conformer")
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
