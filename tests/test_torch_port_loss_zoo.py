"""The loss zoo's heads against the JAX package's (CPU): the 17 names of
``AngularPenaltySMLoss``, ``adasoftmax_v1``/``_v2``, the proxy heads
(``ProxyAnchor``, ``ProxyNCA``, ``MP``, ``MMP``, ``MP_Balance``,
``MMP_Balance``, ``MMP_Balance_MTL``), the pair heads
(``MultiSimilarity``, ``MultiSimilarity_v2``, ``MSSoftmax``,
``MSAmSoftmax``, ``CircleLoss``, ``CircleLossV2``) and ``TripletLoss``.

The same embeddings ``[B, 2, D]`` (numpy, from a seed), unique labels
and head weights (the JAX init, carried by ``weights.params_from_jax``)
go through both, at a small size (D 32, 50 classes, 8 speakers × 2) and,
for the heads with a class matrix, at the default stack's (D 512, 13,103
classes, 32 × 2) with embedding norms spread over ``FULL_NORMS``. fp32:
loss and prec1 to 1e-5 relative, the gradients with respect to the
embeddings and to each head parameter to 1e-5 of their largest value.
A non-finite value must be non-finite in both; where the loss overflows
(MMP's, in both packages), each gradient entry is finite, or not, in the
same places. No value is refereed by another run: the largest miss at
full width is MP's d/dx, 3.5e-6 of its largest value (its logits are
the unnormalized query's dot products times ``w`` = 10). A logit bias
under softmaxes only (``MP``'s ``b``) has a zero gradient by
construction: there both give rounding noise, held to 1e-5 of the
gradient of ``w``.

Two AdaBelief steps (the default stack's optimizer and rate) of MP and
CircleLoss on a linear trunk at the default stack's pooled width
(3,072 → D), with embeddings of different speakers alike as a random
trunk gives them: the first step more than doubles the loss in JAX, and
the port follows it to 1e-4.

``TripletLoss``: jax.random's draws cannot be reproduced in torch, so
the negatives that the JAX head mines with its fixed ``PRNGKey(0)`` are
recomputed here with jax.random, and the port's
``triplet_from_indices`` is held to the JAX head on those.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.losses import build_loss as j_build_loss
from speakerverification_tpu.registry import LOSSES as J_LOSSES
from speakerverification_tpu.registry import OPTIMIZERS as J_OPTIMIZERS
import speakerverification_tpu.optim  # noqa: F401  (registers)
from speakerverification_tpu_torch.losses import LOSSES, build_loss
from speakerverification_tpu_torch.losses.common import l2_normalize
from speakerverification_tpu_torch.losses.triplet import (
    mine_negatives,
    triplet_from_indices,
)
from speakerverification_tpu_torch.optim import OPTIMIZERS
from speakerverification_tpu_torch.weights import params_from_jax

NEW_HEADS = ["AngularPenaltySMLoss", "adasoftmax_v1", "adasoftmax_v2",
             "ProxyAnchor", "ProxyNCA", "MP", "MMP", "MP_Balance",
             "MMP_Balance", "MMP_Balance_MTL", "MultiSimilarity",
             "MultiSimilarity_v2", "MSSoftmax", "MSAmSoftmax", "CircleLoss",
             "CircleLossV2", "TripletLoss"]
CLASS_HEADS = [n for n in NEW_HEADS if n not in (
    "MultiSimilarity", "MultiSimilarity_v2", "CircleLoss", "CircleLossV2",
    "TripletLoss")]
SMALL = (32, 50, 8)               # D, nClasses, speakers
FULL = (512, 13103, 32)
# the range of the embedding norms in the default stack's training
# forward at random init: 16.16-71.96 in chip_smoke.py's path L1 (32 x 2
# crops of 2 s on the card)
FULL_NORMS = (16.0, 72.0)


def _inputs(size, seed=0):
    D, n_classes, B = size
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 2, D)).astype(np.float32)
    # a speaker's two utterances near a common centre, so that some pairs
    # and classes hit (prec1 strictly between 0 and 100)
    x += 1.5 * rng.normal(0, 1, (B, 1, D)).astype(np.float32)
    if size == FULL:
        lo, hi = FULL_NORMS
        norms = np.exp(rng.uniform(np.log(lo), np.log(hi), (B, 2, 1)))
        x = (x / np.linalg.norm(x, axis=-1, keepdims=True)
             * norms).astype(np.float32)
    label = rng.permutation(n_classes)[:B].astype(np.int32)
    return x, label


_CACHE = {}


@pytest.fixture(scope="module")
def jax_heads():
    """(name, size) → (JAX head, its params, the JAX loss/prec1 and
    gradients), computed once per module."""
    def get(name, size):
        if (name, size) not in _CACHE:
            x, label = _inputs(size)
            D, n_classes, _ = size
            jhead = j_build_loss(name, nOut=D, nClasses=n_classes)
            variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                   jnp.asarray(label))
            params = variables.get("params", {})

            def f(p, emb):
                return jhead.apply({"params": p}, emb, jnp.asarray(label))

            (jl, jp), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
            to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
            _CACHE[(name, size)] = (x, label, to_np(params), float(jl),
                                    float(jp), to_np(gp), np.asarray(gx))
        return _CACHE[(name, size)]
    yield get
    _CACHE.clear()


def _err(got, ref):
    """(max |got - ref| over the entries finite in ``ref``, max |ref|
    there); the two must be finite in the same places."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin), "finiteness differs"
    if not fin.any():
        return 0.0, 1e-6
    return (float(np.max(np.abs(got[fin] - ref[fin]))),
            max(float(np.max(np.abs(ref[fin]))), 1e-6))


def _agree(got, ref, rel, what):
    """``got`` within ``rel`` of the largest ``ref``."""
    err, scale = _err(got, ref)
    assert err <= rel * scale, \
        f"{what}: max err {err:.3e} > {rel:g} * {scale:.3e}"


def _port_head(name, size, params):
    D, n_classes, _ = size
    head = build_loss(name, nOut=D, nClasses=n_classes)
    if params:
        sd = params_from_jax({"loss": params})
        head.load_state_dict({k[len("loss."):]: v for k, v in sd.items()},
                             strict=True)
    return head


def _run(head, x, label):
    xt = torch.from_numpy(x).requires_grad_(True)
    named = list(head.named_parameters())
    tl, tp = head(xt, torch.from_numpy(label))
    grads = torch.autograd.grad(tl, [xt, *(p for _, p in named)])
    return (float(tl.detach()), float(tp),
            {n: g.numpy() for n, g in zip(["x"] + [n for n, _ in named],
                                          grads)})


def _check(name, size, jax_heads):
    x, label, params, jl, jp, gp, gx = jax_heads(name, size)
    head = _port_head(name, size, params)
    tl, tp, tg = _run(head, x, label)
    assert tp == pytest.approx(jp, rel=1e-5, abs=1e-5)
    want = params_from_jax({"loss": gp}) if params else {}
    assert {f"loss.{n}" for n in tg if n != "x"} == set(want)
    if not np.isfinite(jl):
        # an overflowing head: its loss and each gradient entry are
        # finite, or not, in the same places in both
        assert not np.isfinite(tl)
        for n, g in tg.items():
            ref = gx if n == "x" else want[f"loss.{n}"].numpy()
            assert np.array_equal(np.isfinite(g), np.isfinite(ref)), n
        return tl
    _agree(tl, jl, 1e-5, f"{name} loss")
    _agree(tg["x"], gx, 1e-5, f"{name} d/dx")
    for n, g in tg.items():
        if n == "x":
            continue
        ref = want[f"loss.{n}"].numpy()
        if name in ("MP", "MP_Balance") and n == "b":
            # a shift of every logit of two softmaxes: zero up to rounding
            bound = 1e-5 * abs(float(tg["w"]))
            assert abs(float(g)) <= bound and abs(float(ref)) <= bound
        else:
            _agree(g, ref, 1e-5, f"{name} d/d{n}")
    return tl


@pytest.mark.parametrize("name", [n for n in NEW_HEADS if n != "TripletLoss"])
def test_head_matches_jax_small(name, jax_heads):
    _check(name, SMALL, jax_heads)


# MMP's exp(w·query·centre ± b) passes fp32's largest value once
# |query|·cos > 8.4 (w 10, b -5): at these norms it does for a speaker's
# own centre, in JAX as in the port (ROADMAP C.13)
OVERFLOW = {"MMP", "MMP_Balance", "MMP_Balance_MTL"}


@pytest.mark.parametrize("name", CLASS_HEADS)
def test_head_matches_jax_full_width(name, jax_heads):
    """D 512 × 13,103 classes × 32 × 2, the default stack's head width;
    the loss is finite in both but where MMP overflows in both."""
    torch.set_num_threads(2)
    assert np.isfinite(_check(name, FULL, jax_heads)) == (
        name not in OVERFLOW)


def test_circle_v2_masked_overflow_matches_jax():
    """CircleLossV2 exponentiates every pair before masking: a pair of
    cosine below about −0.55 overflows fp32 outside the masks, and the
    masked-out inf times its zero cotangent makes the gradient NaN while
    the loss stays finite, in JAX as in the port (ROADMAP C.13)."""
    x, label = _inputs(SMALL)
    x[1, 1] = -x[0, 0]              # an opposite pair of two speakers
    jhead = j_build_loss("CircleLossV2")
    (jl, _), jg = jax.value_and_grad(
        lambda e: jhead.apply({}, e, jnp.asarray(label)), has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl, _ = build_loss("CircleLossV2")(xt, torch.from_numpy(label))
    (tg,) = torch.autograd.grad(tl, [xt])
    assert np.isfinite(float(jl)) and float(tl.detach()) == pytest.approx(
        float(jl), rel=1e-5)
    assert np.array_equal(np.isfinite(tg.numpy()),
                          np.isfinite(np.asarray(jg)))
    assert not np.isfinite(tg.numpy()).all()


def _trunk_inputs(seed=0):
    """Pooled features ``[8, 2, 3072]`` (8 speakers × 2) with a part
    common to all speakers, a linear trunk ``[3072, 32]`` scaled to a
    median embedding norm of 16, and unique labels of 50 classes."""
    D, n_classes, B = SMALL
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 2, 3072)).astype(np.float32)
    x += 1.5 * rng.normal(0, 1, (B, 1, 3072)).astype(np.float32)
    x += 3.0 * rng.normal(0, 1, (1, 1, 3072)).astype(np.float32)
    wt = rng.normal(0, 1, (3072, D)).astype(np.float32)
    wt *= np.float32(16.0 / np.median(np.linalg.norm(x @ wt, axis=-1)))
    return x, wt, rng.permutation(n_classes)[:B].astype(np.int32)


@pytest.mark.parametrize("name", ["MP", "CircleLoss"])
def test_adabelief_steps_diverge_as_in_jax(name):
    """The heads that diverge on the default stack (ROADMAP C.13): two
    AdaBelief steps (lr 3e-3, weight decay 2e-5) of the trunk and the
    head. AdaBelief's first step moves every weight by about ±lr, so an
    embedding coordinate moves by lr·Σ|feature| (~7 over 3,072 features)
    and the first step more than doubles the loss in JAX; the port's
    losses before, between and after the steps are JAX's to 1e-4
    (measured 1.4e-5 for MP, 3e-7 for CircleLoss)."""
    from speakerverification_tpu.optim import build_optimizer as j_build
    from speakerverification_tpu_torch.optim import (
        apply_updates,
        build_optimizer,
    )
    import optax
    x, wt, label = _trunk_inputs()
    D, n_classes, _ = SMALL
    jhead = j_build_loss(name, nOut=D, nClasses=n_classes)
    hparams = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x @ wt),
                         jnp.asarray(label)).get("params", {})

    def jloss(p):
        return jhead.apply({"params": p["head"]}, jnp.asarray(x) @ p["trunk"],
                           jnp.asarray(label))[0]

    jp = {"trunk": jnp.asarray(wt), "head": hparams}
    jtx = j_build("AdaBelief", 3e-3, weight_decay=2e-5)
    js = jtx.init(jp)
    vg, jupdate = jax.jit(jax.value_and_grad(jloss)), jax.jit(jtx.update)
    want = []
    for _ in range(2):
        loss, g = vg(jp)
        want.append(float(loss))
        u, js = jupdate(g, js, jp)
        jp = optax.apply_updates(jp, u)
    want.append(float(vg(jp)[0]))

    head = _port_head(name, SMALL, jax.tree.map(np.asarray, hparams))
    tp = {"trunk": torch.from_numpy(wt.copy()),
          **{f"loss.{n}": p.detach().clone()
             for n, p in head.named_parameters()}}

    def tloss(p):
        emb = torch.from_numpy(x) @ p["trunk"]
        return torch.func.functional_call(
            head, {k[len("loss."):]: v for k, v in p.items() if k != "trunk"},
            (emb, torch.from_numpy(label)))[0]

    ttx = build_optimizer("AdaBelief", 3e-3, weight_decay=2e-5)
    ts = ttx.init(tp)
    got = []
    for _ in range(2):
        ps = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        loss = tloss(ps)
        got.append(float(loss.detach()))
        u, ts = ttx.update(dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values())))), ts, tp)
        apply_updates(tp, u)
    got.append(float(tloss(tp)))
    assert want[1] > 2 * want[0] and got[1] > 2 * got[0], (want, got)
    assert got == pytest.approx(want, rel=1e-4)


def _jax_negidx(anchor, positive, hard_rank, hard_prob, margin):
    """The JAX head's mining (``losses/triplet.py``) with its fixed
    ``PRNGKey(0)``, replayed with jax.random."""
    B = anchor.shape[0]
    d2 = (jnp.sum(anchor ** 2, -1)[:, None]
          + jnp.sum(positive ** 2, -1)[None, :] - 2.0 * anchor @ positive.T)
    sim = -d2
    k_choice, k_prob = jax.random.split(jax.random.PRNGKey(0))
    self_mask = jnp.eye(B, dtype=bool)
    if hard_rank < 0:
        own = jnp.diag(sim)
        semi = (~self_mask) & (sim > (own - margin)[:, None]) \
            & (sim < own[:, None])
        scores = jnp.where(semi, 0.0, -jnp.inf)
        gumbel = jax.random.gumbel(k_choice, (B, B))
        fallback = jnp.where(self_mask, -jnp.inf, gumbel)
        return jnp.where(jnp.any(semi, axis=1),
                         jnp.argmax(scores + gumbel, axis=1),
                         jnp.argmax(fallback, axis=1))
    order = jnp.argsort(-jnp.where(self_mask, -jnp.inf, sim), axis=1)
    k = jax.random.randint(k_choice, (B,), 0, max(hard_rank, 1))
    hard = jnp.take_along_axis(order, k[:, None], axis=1)[:, 0]
    rand = jax.random.randint(jax.random.fold_in(k_choice, 1), (B,), 0, B - 1)
    rand = jnp.where(rand >= jnp.arange(B), rand + 1, rand)
    use_hard = jax.random.uniform(k_prob, (B,)) < hard_prob
    return jnp.where(use_hard, hard, rand)


@pytest.mark.parametrize("kw", [{}, {"hard_rank": 3, "hard_prob": 0.5},
                                {"hard_rank": -1, "margin": 0.5}])
def test_triplet_from_jax_indices(kw):
    x, label = _inputs(SMALL)
    jhead = j_build_loss("TripletLoss", **kw)
    margin = kw.get("margin", 0.2)

    def f(emb):
        return jhead.apply({}, emb, jnp.asarray(label))

    (jl, jp), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    from speakerverification_tpu.losses.common import l2_normalize as jn
    negidx = np.asarray(_jax_negidx(jn(jnp.asarray(x[:, 0]), -1),
                                    jn(jnp.asarray(x[:, 1]), -1),
                                    kw.get("hard_rank", 0),
                                    kw.get("hard_prob", 0.0), margin))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl, tp = triplet_from_indices(l2_normalize(xt[:, 0], -1),
                                  l2_normalize(xt[:, 1], -1),
                                  torch.from_numpy(negidx), margin)
    (tg,) = torch.autograd.grad(tl, [xt])
    _agree(float(tl), float(jl), 1e-5, "triplet loss")
    assert float(tp) == pytest.approx(float(jp), rel=1e-5, abs=1e-5)
    _agree(tg.numpy(), np.asarray(gx), 1e-5, "triplet d/dx")


@pytest.mark.parametrize("kw", [{}, {"hard_rank": 3, "hard_prob": 0.5},
                                {"hard_rank": -1, "margin": 0.5}])
def test_triplet_head_mines_a_fixed_draw(kw):
    """The port's head mines from a generator seeded with 0 on every
    call (as the JAX step's fixed key): two calls agree, each negative is
    another speaker's, and the loss is that of its own negatives."""
    x, label = _inputs(SMALL)
    head = build_loss("TripletLoss", **kw)
    xt = torch.from_numpy(x)
    l1, p1 = head(xt, torch.from_numpy(label))
    l2, p2 = head(xt, torch.from_numpy(label))
    assert float(l1) == float(l2) and float(p1) == float(p2)
    a, p = l2_normalize(xt[:, 0], -1), l2_normalize(xt[:, 1], -1)
    d2 = (a ** 2).sum(-1)[:, None] + (p ** 2).sum(-1)[None, :] - 2 * a @ p.T
    neg = mine_negatives(-d2, head.hard_rank, head.hard_prob, head.margin,
                         torch.Generator().manual_seed(0))
    assert not bool((neg == torch.arange(len(neg))).any())
    want = triplet_from_indices(a, p, neg, head.margin)
    assert float(l1) == float(want[0]) and float(p1) == float(want[1])


def test_registries_match_jax():
    """Every JAX loss head (the class-sharded one since the multi-GPU
    slice), and every JAX optimizer, is registered in the port."""
    assert set(LOSSES.names()) == set(J_LOSSES.names())
    assert set(OPTIMIZERS.names()) == set(J_OPTIMIZERS.names())


@pytest.mark.parametrize("name", NEW_HEADS)
def test_config_keys_follow_jax(name):
    """The keys a config may set are the JAX head's fields (but the
    sizes, ``test_normalize`` and what the head takes from ``hparams``)."""
    import dataclasses
    import inspect
    jfields = {f.name for f in dataclasses.fields(J_LOSSES.get(name))} - {
        "parent", "name", "test_normalize"}
    got = set(inspect.signature(LOSSES.get(name).__init__).parameters) - {
        "self"}
    assert got == jfields
    assert build_loss(name, nOut=8, nClasses=5).test_normalize == \
        j_build_loss(name, nOut=8, nClasses=5).test_normalize
