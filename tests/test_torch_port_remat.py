"""``model.remat``: each SE-Res2Net block recomputed in the backward pass.

A small ``ECAPA_TDNN`` and a small ``Raw3_ECAPA``-shaped hybrid give the
same loss, gradients and BatchNorm running statistics with and without
``remat`` on the CPU in fp32 (``torch.equal``, or within 1e-6 of the
largest magnitude), also through the train step in bf16; the state_dict
keys are the same, a JAX-initialized model runs the same forward, and
the training gradient matches the JAX module's with ``remat`` on (1e-4,
the models' parity bar). Eval never checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA
from speakerverification_tpu_torch.builder import build_model
from speakerverification_tpu_torch.models import ecapa_tdnn as tecapa_mod
from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN as TECAPA
from speakerverification_tpu_torch.models.hybrids import RawECAPAHybrid
from speakerverification_tpu_torch.models.rawnet3 import RawNet3
from speakerverification_tpu_torch.ops.frontend import FrontendConfig
from speakerverification_tpu_torch.weights import params_to_jax

from test_torch_port_helpers import close, init_pair, t

ECAPA_SMALL = dict(lin_neurons=16, channels=(32, 32, 32, 32, 96),
                   attention_channels=8, se_channels=8, res2net_scale=4)


def _feats(seed=1, shape=(3, 41, 20)):
    return np.abs(np.random.default_rng(seed).normal(0, 1, shape)
                  ).astype(np.float32)


def _ecapa_pair():
    torch.manual_seed(0)
    plain = TECAPA(n_mels=20, **ECAPA_SMALL)
    remat = TECAPA(n_mels=20, **ECAPA_SMALL, remat=True)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _hybrid(remat: bool):
    cfg = FrontendConfig()
    return RawECAPAHybrid(
        raw_branch=RawNet3(nOut=24, C=64, context_dim=96),
        ecapa=TECAPA(n_mels=cfg.n_mels, **ECAPA_SMALL, log_input=False,
                     input_norm=True, remat=remat),
        frontend=cfg)


def _hybrid_pair():
    torch.manual_seed(0)
    plain = _hybrid(False)
    remat = _hybrid(True)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _grads(model, x):
    model.train()
    out = model(x)
    loss = (out.float() ** 2).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    return loss.detach(), dict(zip(names, grads)), stats


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if torch.equal(a, b):
        return
    scale = max(float(b.abs().max()), 1e-6)
    err = float((a - b).abs().max())
    assert err <= 1e-6 * scale, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("which", ["ECAPA_TDNN", "Raw3_ECAPA"])
def test_remat_gives_equal_loss_gradients_and_statistics(which):
    torch.set_num_threads(2)
    if which == "ECAPA_TDNN":
        plain, remat = _ecapa_pair()
        x = t(_feats())
    else:
        plain, remat = _hybrid_pair()
        x = t((0.1 * np.random.default_rng(2).normal(0, 1, (2, 4000)))
              .astype(np.float32))
    calls = []
    real = tecapa_mod.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tecapa_mod.checkpoint = counted
    try:
        l1, g1, s1 = _grads(plain, x)
        assert not calls
        l2, g2, s2 = _grads(remat, x)
    finally:
        tecapa_mod.checkpoint = real
    n_blocks = len(ECAPA_SMALL["channels"]) - 2
    assert len(calls) == n_blocks
    _same(l2, l1, "loss")
    assert g1.keys() == g2.keys()
    for k in g1:
        assert (g1[k] is None) == (g2[k] is None), k
        if g1[k] is not None:
            _same(g2[k], g1[k], k)
    # the recomputation leaves the running statistics as the forward set them
    for k in s1:
        _same(s2[k], s1[k], k)


def test_remat_keys_and_jax_weights_forward():
    jm = JECAPA(**ECAPA_SMALL)
    plain, remat = _ecapa_pair()
    assert list(plain.state_dict()) == list(remat.state_dict())
    feats = _feats(3)
    v = init_pair(jm, remat, jnp.asarray(feats))
    ref = jm.apply(v, jnp.asarray(feats))
    with torch.no_grad():
        got = remat(t(feats)).numpy()
    close(got, ref, 1e-4, "ECAPA_TDNN remat, JAX weights")
    # and the weights go back to the JAX layout unchanged
    params, _ = params_to_jax(remat.state_dict())
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            np.asarray, dict(v["params"])))


def test_remat_training_gradient_matches_jax_remat():
    jm = JECAPA(**ECAPA_SMALL, remat=True)
    tm = TECAPA(n_mels=20, **ECAPA_SMALL, remat=True)
    feats = _feats(4)
    v = init_pair(jm, tm, jnp.asarray(feats))

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(feats), train=True,
                          mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    jgrads = jax.grad(loss_fn)(v["params"])
    _, tgrads, _ = _grads(tm, t(feats))
    # the gradients in the state_dict's place, for the weight bridge
    want, _ = params_to_jax({**tm.state_dict(), **tgrads})
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_j) == len(flat_t)
    # against the largest gradient: a softmax over time ignores the
    # attention conv's bias, whose gradient is rounding noise on both sides
    scale = max(float(np.max(np.abs(g))) for _, g in flat_j)
    for path, g in flat_j:
        err = np.max(np.abs(np.asarray(flat_t[path]).reshape(np.shape(g))
                            - np.asarray(g)))
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


def test_remat_bf16_train_step_matches():
    """Through the train step's bf16 ``functional_call``: the recomputation
    uses the same bf16 copies, so both runs agree."""
    torch.set_num_threads(2)
    from speakerverification_tpu_torch.encoder import SpeakerEncoder
    from speakerverification_tpu_torch.losses import build_loss
    from speakerverification_tpu_torch.optim import build_optimizer
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    wave = torch.from_numpy((0.1 * np.random.default_rng(5).normal(
        0, 1, (4, 2, 4000))).astype(np.float32))
    label = torch.arange(4)
    out = []
    for remat in (False, True):
        torch.manual_seed(0)
        enc = SpeakerEncoder(backbone=_hybrid(remat), feature_type="raw",
                             loss=build_loss("AAmSoftmax", nOut=40,
                                             nClasses=4, margin=0.2,
                                             scale=30),
                             compute_dtype=torch.bfloat16)
        enc.backbone.compute_dtype = torch.bfloat16
        tx = build_optimizer("adam", learning_rate=1e-3)
        state = create_train_state(enc, tx, seed=0)
        step = make_train_step(enc, tx, compute_dtype=torch.bfloat16)
        state, m = step(state, wave, label, 1e-3)
        out.append((float(m["loss"]),
                    {k: p.detach().clone() for k, p in state.params.items()}))
    assert out[0][0] == out[1][0]
    for k, p in out[0][1].items():
        _same(out[1][1][k], p, k)


def test_eval_ignores_remat():
    plain, remat = _ecapa_pair()
    plain.eval()
    remat.eval()
    real = tecapa_mod.checkpoint

    def refuse(*a, **k):
        raise AssertionError("eval checkpointed a block")

    tecapa_mod.checkpoint = refuse
    try:
        x = t(_feats(6))
        with torch.no_grad():
            _same(remat(x), plain(x), "eval")
        _same(remat(x), plain(x), "eval with grad on")
    finally:
        tecapa_mod.checkpoint = real


@pytest.mark.parametrize("name", ["ECAPA_TDNN", "Raw3_ECAPA", "Raw_ECAPA",
                                  "Raw_ECAPA_sinc_asp", "Raw_ECAPA_conv_asp",
                                  "Raw_ECAPA_sinc_gru", "Raw_ECAPA_hype"])
def test_builders_pass_remat_on(name):
    kw = dict(nOut=512, audio_spec={"sample_rate": 16000,
                                    "sentence_len": 0.5})
    if name == "ECAPA_TDNN":
        kw = dict(nOut=16, channels=[32, 32, 32, 32, 96],
                  attention_channels=8, se_channels=8, res2net_scale=4)
    for remat in (False, True):
        model = build_model(name, remat=remat, **kw)
        ecapa = model if name == "ECAPA_TDNN" else model.ecapa
        assert ecapa.remat is remat
