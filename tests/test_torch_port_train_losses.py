"""The port's loss heads against the JAX package's (CPU, fp32).

The same embeddings ``[B, nPerSpeaker, D]``, labels and head weights go
through both; loss and prec1 agree to 1e-6 (relative), the gradients
with respect to the embeddings and to the head's weights to 1e-5 of
their largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.losses import build_loss as j_build_loss
from speakerverification_tpu_torch.losses import build_loss as t_build_loss
from speakerverification_tpu_torch.losses.common import (
    cross_entropy,
    flatten_grouped,
    top1_percent,
)
from speakerverification_tpu_torch.weights import (
    init_weights_,
    params_from_jax,
)

from test_torch_port_helpers import close

HEADS = [("ARmSoftmax", {"margin": 0.2, "scale": 30}),
         ("AAmSoftmax", {"margin": 0.2, "scale": 30}),
         ("AAmSoftmax", {"margin": 0.2, "scale": 30, "easy_margin": True}),
         ("AmSoftmax", {"margin": 0.1, "scale": 30}),
         ("Softmax", {})]


def _inputs(seed: int, B=6, n_per=2, D=16, n_classes=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, n_per, D)).astype(np.float32)
    label = rng.permutation(n_classes)[:B].astype(np.int32)
    return x, label


@pytest.mark.parametrize("name,kw", HEADS,
                         ids=[f"{n}{'-easy' if k.get('easy_margin') else ''}"
                              for n, k in HEADS])
def test_head_matches_jax(name, kw):
    x, label = _inputs(0)
    n_classes = 11
    jhead = j_build_loss(name, nOut=16, nClasses=n_classes, **kw)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(label))
    params = jax.tree.map(np.asarray, variables["params"])
    # row 0 nearly opposite its class (AAmSoftmax's ``cosine - mm``
    # branch, past th = cos(π - m)), row 1 on its class (a top-1 hit)
    m = (params["W"] if "W" in params else params["weight"].T
         if "weight" in params else params["Dense_0"]["kernel"])
    m = m / np.linalg.norm(m, axis=0, keepdims=True)
    x[0] = -m[:, label[0]] + 0.02 * np.random.default_rng(5).normal(
        0, 1, x[0].shape)
    x[1] = 3.0 * m[:, label[1]] + 0.02 * np.random.default_rng(6).normal(
        0, 1, x[1].shape)
    thead = t_build_loss(name, nOut=16, nClasses=n_classes, **kw)
    state = params_from_jax({"loss": params})
    thead.load_state_dict({k[len("loss."):]: v for k, v in state.items()})

    def jloss(p, emb):
        loss, prec = jhead.apply({"params": p}, emb, jnp.asarray(label))
        return loss, prec

    (jl, jp), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl, tp = thead(xt, torch.from_numpy(label))
    grads = torch.autograd.grad(tl, [xt, *thead.parameters()])
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tp) == pytest.approx(float(jp), abs=1e-6)
    close(grads[0].numpy(), np.asarray(jgx), 1e-5, f"{name} d/dx")
    names = [n for n, _ in thead.named_parameters()]
    got = params_from_jax(  # JAX gradient tree in the port's layout
        {"loss": jax.tree.map(np.asarray, jgp)})
    for n, g in zip(names, grads[1:]):
        close(g.numpy(), got[f"loss.{n}"].numpy(), 1e-5, f"{name} d/d{n}")


def test_heads_hit_top1_on_their_own_class_weights():
    """prec1 counts hits: embeddings equal to their class's weight
    column score 100 % in ARmSoftmax and AAmSoftmax."""
    for name in ("ARmSoftmax", "AAmSoftmax"):
        head = t_build_loss(name, nOut=8, nClasses=5, margin=0.2, scale=30)
        init_weights_(head, torch.Generator().manual_seed(0))
        w = head.W.detach() if name == "ARmSoftmax" else \
            head.weight.detach().T
        label = torch.tensor([0, 3, 4])
        x = w[:, label].T[:, None, :].repeat(1, 2, 1)
        _, prec = head(x, label)
        assert float(prec) == 100.0


def test_common_helpers():
    x = torch.arange(12.0).reshape(2, 3, 2)
    flat, lab = flatten_grouped(x, torch.tensor([4, 7]))
    assert flat.shape == (6, 2) and lab.tolist() == [4, 4, 4, 7, 7, 7]
    logits = torch.tensor([[2.0, 1.0, 0.1], [0.0, 3.0, 1.0]])
    labels = torch.tensor([0, 2])
    want = torch.nn.functional.cross_entropy(logits, labels)
    assert float(cross_entropy(logits, labels)) == pytest.approx(float(want))
    assert float(top1_percent(logits, labels)) == 50.0


def test_build_loss_drops_keys_a_head_does_not_take():
    head = t_build_loss("ARmSoftmax", nOut=4, nClasses=3, margin=0.2,
                        scale=30, easy_margin=True, name_unused=1)
    assert head.margin == 0.2 and head.W.shape == (4, 3)
    with pytest.raises(KeyError, match="registered"):
        t_build_loss("NoSuchHead")
