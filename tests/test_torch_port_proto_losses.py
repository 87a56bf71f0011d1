"""The metric-learning heads and their sums against the JAX package
(CPU): ``AngularProto``, ``Prototypical``, ``GE2ELoss`` (softmax and
contrast), ``GE2ELossV2``, ``GE2ELoss_fusion``, ``SoftmaxAngularProto``,
``AmSoftmaxProto``, ``AAmSoftmaxProto`` and ``AAmSoftmaxAP``.

The same embeddings ``[B, nPerSpeaker, D]``, labels and head weights go
through both. fp32: loss to 1e-6 relative, prec1 to 1e-4 (percent: XLA
divides by the batch as a product with its reciprocal, one fp32 ulp of
83.3 % off torch's quotient), the gradients with respect to the
embeddings and to every head parameter (``jax.grad``) to 1e-5 of their
largest value. A logit bias ``b`` under a softmax has a zero gradient by
construction (the softmax ignores a shift of all its logits): there
both packages give rounding noise, held to |g| ≤ 1e-6 (measured ≤ 4e-7;
the gradient of ``w`` is ~0.1). bf16 (bf16 embeddings and head
weights): the loss has JAX's dtype and lies within one bf16 ulp
(2⁻⁷ relative) of JAX's: the cosines and the cross-entropy run in bf16
in both (measured: equal bit for bit on three seeds of each, 0.1–0.8 %
from fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu.losses import build_loss as j_build_loss
from speakerverification_tpu_torch.builder import eval_normalize_from_hparams
from speakerverification_tpu_torch.losses import LOSSES, build_loss as t_build_loss
from speakerverification_tpu_torch.weights import (
    init_weights_,
    params_from_jax,
    params_to_jax,
)

from test_torch_port_helpers import close

N_CLASSES = 11
HEADS = [("AngularProto", {}, 3),
         ("AngularProto", {"init_w": 2.0, "init_b": 0.5}, 2),
         ("Prototypical", {}, 3),
         ("GE2ELoss", {}, 3),
         ("GE2ELoss", {"loss_method": "contrast"}, 3),
         ("GE2ELossV2", {}, 3),
         ("GE2ELossV2", {"loss_method": "contrast"}, 2),
         ("GE2ELoss_fusion", {}, 3),
         ("SoftmaxAngularProto", {}, 2),
         ("AmSoftmaxProto", {"margin": 0.1, "scale": 30}, 2),
         ("AAmSoftmaxProto", {"margin": 0.2, "scale": 30}, 2),
         ("AAmSoftmaxAP", {"margin": 0.25, "scale": 30}, 2),
         ("AAmSoftmaxAP", {"margin": 0.2, "scale": 30,
                           "easy_margin": True}, 2)]
IDS = [f"{n}-{i}" for i, (n, _, _) in enumerate(HEADS)]


def _inputs(seed: int, n_per: int, B=6, D=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, n_per, D)).astype(np.float32)
    # each speaker's utterances near a common centre, so that some
    # prototypes hit (prec1 between 0 and 100)
    x[:3] += 2.0 * rng.normal(0, 1, (3, 1, D)).astype(np.float32)
    label = rng.permutation(N_CLASSES)[:B].astype(np.int32)
    return x, label


def _pair(name, kw, x, label):
    jhead = j_build_loss(name, nOut=16, nClasses=N_CLASSES, **kw)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(label))
    params = jax.tree.map(np.asarray, variables.get("params", {}))
    thead = t_build_loss(name, nOut=16, nClasses=N_CLASSES, **kw)
    state = params_from_jax({"loss": params}) if params else {}
    thead.load_state_dict({k[len("loss."):]: v for k, v in state.items()},
                          strict=True)
    return jhead, variables.get("params", {}), thead


@pytest.mark.parametrize("name,kw,n_per", HEADS, ids=IDS)
def test_head_matches_jax(name, kw, n_per):
    x, label = _inputs(0, n_per)
    jhead, jparams, thead = _pair(name, kw, x, label)

    def jloss(p, emb):
        return jhead.apply({"params": p}, emb, jnp.asarray(label))

    (jl, jp), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl, tp = thead(xt, torch.from_numpy(label))
    params = list(thead.named_parameters())
    grads = torch.autograd.grad(tl, [xt, *(p for _, p in params)])
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tp) == pytest.approx(float(jp), abs=1e-4)
    close(grads[0].numpy(), np.asarray(jgx), 1e-5, f"{name} d/dx")
    want = params_from_jax({"loss": jax.tree.map(np.asarray, jgp)}) \
        if params else {}
    assert {f"loss.{n}" for n, _ in params} == set(want)
    for (n, _), g in zip(params, grads[1:]):
        ref = want[f"loss.{n}"].numpy()
        if n.endswith("b") and _shift_invariant(kw, n):
            assert abs(float(g)) <= 1e-6 and abs(float(ref)) <= 1e-6, n
        else:
            close(g.numpy(), ref, 1e-5, f"{name} d/d{n}")


def _shift_invariant(kw: dict, param: str) -> bool:
    """Whether the bias ``param`` only shifts the logits of one softmax:
    every head's but a contrast GE2E's (``GE2ELoss_fusion``'s second),
    whose sigmoids it moves."""
    return not ("GE2ELossV2_1" in param
                or kw.get("loss_method") == "contrast")


@pytest.mark.parametrize("name", ["AngularProto", "AAmSoftmaxAP",
                                  "GE2ELoss_fusion"])
def test_bf16_loss(name):
    """bf16 embeddings and head weights: the loss is bf16 in both
    packages and within one bf16 ulp of JAX's."""
    x, label = _inputs(1, 2)
    kw = {"margin": 0.25, "scale": 30} if name == "AAmSoftmaxAP" else {}
    jhead, jparams, thead = _pair(name, kw, x, label)
    jl, _ = jhead.apply({"params": jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), jparams)},
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(label))
    thead = thead.to(torch.bfloat16)
    tl, _ = thead(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(label))
    assert jl.dtype == jnp.bfloat16 and tl.dtype == torch.bfloat16
    assert float(tl) == pytest.approx(float(jl), rel=2 ** -7)


@pytest.mark.parametrize("name", ["SoftmaxAngularProto", "AmSoftmaxProto",
                                  "AAmSoftmaxProto", "AAmSoftmaxAP"])
def test_summed_heads_take_exactly_two_per_speaker(name):
    head = t_build_loss(name, nOut=8, nClasses=5)
    with pytest.raises(ValueError, match="exactly 2 per speaker"):
        head(torch.zeros(4, 3, 8), torch.arange(4))
    with pytest.raises(ValueError, match="exactly 2 per speaker"):
        head(torch.zeros(4, 8), torch.arange(4))


@pytest.mark.parametrize("name", ["AngularProto", "Prototypical",
                                  "GE2ELoss"])
def test_metric_heads_need_two_per_speaker(name):
    with pytest.raises(ValueError, match="at least 2 per speaker"):
        t_build_loss(name)(torch.zeros(4, 1, 8), None)


def test_registry_and_normalization_follow_jax():
    names = ("AngularProto", "Prototypical", "GE2ELoss", "GE2ELossV2",
             "GE2ELoss_fusion", "SoftmaxAngularProto", "AmSoftmaxProto",
             "AAmSoftmaxProto", "AAmSoftmaxAP")
    for name in names:
        assert name in LOSSES
        want = j_build_loss(name, nOut=8, nClasses=5).test_normalize
        assert t_build_loss(name, nOut=8, nClasses=5).test_normalize == want
        assert eval_normalize_from_hparams(
            {"criterion": {"name": name}}) == want


@pytest.mark.parametrize("name", sorted(LOSSES.names()))
def test_weight_bridge_round_trip(name):
    """``params_to_jax`` is the exact inverse of ``params_from_jax`` for
    every head (the margin heads' matrices at ``loss`` or one scope
    below it, a plain Softmax's ``Dense_0``, the 0-d ``w``/``b``), and
    its tree is the JAX head's."""
    head = t_build_loss(name, nOut=8, nClasses=5)
    init_weights_(head, torch.Generator().manual_seed(3))
    state = {f"loss.{k}": v for k, v in head.state_dict().items()}
    params, stats = params_to_jax(state)
    back = params_from_jax(params, stats, like=state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    jv = j_build_loss(name, nOut=8, nClasses=5).init(
        jax.random.PRNGKey(0), jnp.zeros((4, 2, 8)), jnp.arange(4))
    want = {k: v.shape for k, v in flatten_dict(jv.get("params", {})).items()}
    got = {k: v.shape
           for k, v in flatten_dict(params.get("loss", {})).items()}
    assert got == want


def test_angular_proto_initial_values():
    """``w`` 10 and ``b`` −5, as flax's constant initializers; a seeded
    init keeps them."""
    head = t_build_loss("AAmSoftmaxAP", nOut=8, nClasses=5)
    init_weights_(head, torch.Generator().manual_seed(0))
    assert float(head.AngularProto_0.w) == 10.0
    assert float(head.AngularProto_0.b) == -5.0
    assert head.AngularProto_0.w.shape == ()
