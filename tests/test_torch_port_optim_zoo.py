"""The optimizer zoo on a bridged tree, against the JAX package (CPU).

The tree is a small net of each kind of leaf the weight bridge lays out
differently: a Conv2d kernel (flax ``[kh, kw, in, out]``, the port's
``[out, in, kh, kw]``), a 1-D conv kernel, a BatchNorm (eval), a Dense
kernel, their biases and a margin head's ``W [6, 7]`` (stored as it
is). The JAX net's initial params cross to the port through
``weights.params_from_jax``, and so does each step's gradient.

* Every registered optimizer, 4 steps: the parameters to 1e-6 of their
  largest value, and the whole state, as the port's checkpoints write it
  (``training.checkpoint._opt_to_jax`` through the port's codec), leaf by
  leaf against ``flax.serialization.to_state_dict`` of JAX's: the same
  paths, shapes and dtypes, counts and flags equal, values to 1e-6 of
  the leaf's largest. Shampoo runs with ``epsilon`` 1 here and is held
  to 1e-5 (measured 3.5e-6, a bias): the inverse roots (by SVD) of a
  preconditioner seeded at ε·I amplify fp32 rounding by up to 1/ε in
  the directions the few gradients have not explored (at ε 0.1 the two
  packages differ by 1.2e-4; at the default 1e-4 either package's run
  leaves the float64 one at 1e-2, and ``test_torch_port_train_optim.py``
  holds the default against a float64 run of the port).
  AdamP, SGDP, Adafactor, Shampoo and SWATS act on the flax layout
  (channel views, factored moments, per-axis preconditioners, the
  flatten order), so this is where the bridge's axis rules are held.
* A JAX checkpoint of each zoo optimizer's train state resumes in the
  port, and the port's checkpoint of it resumes in JAX, bit for bit.
* ``adahessian_trace`` and one ``make_adahessian_loss_update`` step
  against JAX's, with the same Rademacher probe (JAX's draw, bridged):
  |Hz| to 1e-5 of its largest value (JAX's Hessian-vector product is
  forward-over-reverse, the port's a double backward); the step's
  parameters and state to 1e-5, or, on a leaf whose |Hz| comes near
  zero, held through JAX's own float64 step.
"""

import flax.linen as fnn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from flax.traverse_util import empty_node, flatten_dict

from speakerverification_tpu.optim import build_optimizer as j_build
from speakerverification_tpu.optim import set_learning_rate as j_set_lr
from speakerverification_tpu.optim.second_order import (
    adahessian_trace as j_trace,
    make_adahessian_loss_update as j_make_step,
)
from speakerverification_tpu.training.checkpoint import (
    load_checkpoint as j_load,
    save_checkpoint as j_save,
)
from speakerverification_tpu_torch import checkpoint as codec
from speakerverification_tpu_torch.optim import (
    OPTIMIZERS,
    apply_updates,
    build_optimizer,
    from_flax,
    set_learning_rate,
)
from speakerverification_tpu_torch.optim.second_order import (
    adahessian_trace,
    make_adahessian_loss_update,
)
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.training.state import TrainState
from speakerverification_tpu_torch.weights import (
    flax_path,
    params_from_jax,
    params_to_jax,
)

# a few keys that change each optimizer's path through its code
KWARGS = {"AdaBelief": {"weight_decay": 1e-3},
          "AdamP": {"weight_decay": 1e-2},
          "SGDP": {"weight_decay": 1e-2, "delta": 0.5},
          "Adafactor": {"weight_decay": 1e-2, "beta1": 0.9},
          "Shampoo": {"momentum": 0.9, "epsilon": 1.0},
          "SWATS": {"weight_decay": 1e-4},
          "Lookahead": {"inner": "AdaBelief", "k": 2},
          "LARS": {"weight_decay": 1e-4, "momentum": 0.9},
          "PID": {"momentum": 0.9},
          "Apollo": {"warmup": 2}}
ZOO = sorted(set(OPTIMIZERS.names()) - {"adam", "Adam", "sgd", "SGD",
                                        "AdaBelief"})
N_STEPS = 4
B, H, W = 3, 6, 9


class JNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Conv(2, (3, 3), padding="VALID",
                              name="Conv2d_0")(x[..., None]))
        b, hh, ww, c = h.shape
        h = h.transpose(0, 2, 1, 3).reshape(b, ww, hh * c)
        h = fnn.Conv(4, (3,), padding="VALID", name="Conv_0")(h)
        h = fnn.BatchNorm(use_running_average=True, name="BatchNorm_0")(h)
        h = fnn.Dense(6, name="Dense_0")(jnp.tanh(h).mean(axis=1))
        return JHead(name="loss")(h)


class JHead(fnn.Module):
    @fnn.compact
    def __call__(self, h):
        w = self.param("W", fnn.initializers.xavier_normal(), (6, 7))
        hn = h / jnp.linalg.norm(h, axis=-1, keepdims=True)
        return 10.0 * hn @ (w / jnp.linalg.norm(w, axis=0, keepdims=True))


class TNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv2d_0 = nn.Conv2d(1, 2, 3)
        self.Conv_0 = nn.Conv1d(2 * (H - 2), 4, 3)
        self.BatchNorm_0 = nn.BatchNorm1d(4)
        self.Dense_0 = nn.Linear(4, 6)
        self.loss = nn.Module()
        self.loss.W = nn.Parameter(torch.zeros(6, 7))

    def forward(self, x):
        h = torch.tanh(self.Conv2d_0(x[:, None]))          # [B, C, H', W']
        b, c, hh, ww = h.shape
        h = h.permute(0, 2, 1, 3).reshape(b, hh * c, ww)
        h = torch.tanh(self.BatchNorm_0(self.Conv_0(h))).mean(dim=2)
        h = self.Dense_0(h)
        hn = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        w = self.loss.W
        return 10.0 * hn @ (w / torch.linalg.vector_norm(w, dim=0,
                                                         keepdim=True))


@pytest.fixture(scope="module")
def net():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    label = np.array([1, 4, 6])
    jv = JNet().init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = {"BatchNorm_0": {
        "mean": jnp.asarray(rng.normal(0, 0.2, 4), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, 4), jnp.float32)}}
    params = jv["params"]
    jloss = _jax_loss(x, label, stats)

    model = TNet().eval()
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats),
        like=model))
    buffers = dict(model.named_buffers())

    def tloss(p):
        logits = torch.func.functional_call(model, {**p, **buffers},
                                            (torch.from_numpy(x),))
        return F.cross_entropy(logits, torch.from_numpy(label))

    # a stream of gradients of the loss at points near the start
    grads = []
    for i in range(N_STEPS):
        shifted = jax.tree.map(lambda a: a * (1 + 0.1 * i), params)
        grads.append(jax.tree.map(np.asarray, jax.grad(jloss)(shifted)))
    return {"params": params, "stats": stats, "jloss": jloss,
            "model": model, "tloss": tloss, "grads": grads, "x": x,
            "label": label}


def _jax_loss(x, label, stats):
    def jloss(p):
        logits = JNet().apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(label)).mean()
    return jloss


_STATS = {"BatchNorm_0": {"mean": np.zeros(4, np.float32),
                          "var": np.ones(4, np.float32)}}


def _port(tree) -> dict:
    """A flax params tree (or one shaped like it) as the port's
    parameters."""
    return {k: v for k, v in params_from_jax(
        jax.tree.map(np.asarray, tree), _STATS).items()
        if k.rpartition(".")[2] not in ("running_mean", "running_var",
                                        "num_batches_tracked")}


def _leaves(tree) -> dict:
    """Path → leaf; an empty node (a stateless transformation's ``{}``)
    is a path with no leaf array."""
    return {"/".join(k): (np.asarray(v) if v is not empty_node else None)
            for k, v in flatten_dict(tree, keep_empty_nodes=True).items()}


def _run(name, net):
    kw = KWARGS.get(name, {})
    jtx = j_build(name, 1e-2, **kw)
    jp = net["params"]
    js = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    for i, g in enumerate(net["grads"]):
        js = j_set_lr(js, jnp.float32(1e-2 * (1 - i / 10)))
        u, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
    return (jp, js) + _port_run(name, net, torch.float32)


def _port_run(name, net, dtype):
    ttx = build_optimizer(name, 1e-2, **KWARGS.get(name, {}))
    # copies: the bridge's tensors may share the JAX arrays' memory
    tp = {k: v.to(dtype, copy=True) for k, v in _port(net["params"]).items()}
    ts = ttx.init(tp)
    for i, g in enumerate(net["grads"]):
        ts = set_learning_rate(ts, 1e-2 * (1 - i / 10))
        u, ts = ttx.update({k: v.to(dtype) for k, v in _port(g).items()},
                           ts, tp)
        apply_updates(tp, u)
    return tp, ts


@pytest.mark.parametrize("name", sorted(OPTIMIZERS.names()))
def test_state_in_flax_layout_matches_jax(name, net):
    jp, js, tp, ts = _run(name, net)
    rel = 1e-5 if name == "Shampoo" else 1e-6
    sd = {**net["model"].state_dict(), **tp}
    want_p = _leaves(jax.tree.map(np.asarray, jp))
    got_p = _leaves(params_to_jax(sd)[0])
    assert set(got_p) == set(want_p)
    for k, ref in want_p.items():
        assert np.max(np.abs(got_p[k] - ref)) <= rel * np.max(np.abs(ref)), k
    got = _leaves(codec.msgpack_restore(codec.msgpack_serialize(
        tckpt._opt_to_jax(ts, sd))))
    want = _leaves(fser.to_state_dict(jax.tree.map(np.asarray, js)))
    assert set(got) == set(want)
    for k, ref in want.items():
        g = got[k]
        if ref is None:
            assert g is None, k
            continue
        assert g.shape == ref.shape and g.dtype == ref.dtype, k
        if ref.dtype.kind in "biu":
            assert np.array_equal(g, ref), k
        else:
            assert np.max(np.abs(g - ref)) <= rel * max(
                np.max(np.abs(ref)), 1e-30), k


@pytest.mark.parametrize("name", ZOO)
def test_checkpoint_round_trip_with_jax(name, net, tmp_path):
    """JAX's checkpoint → the port's ``load_checkpoint`` → the port's
    checkpoint → JAX's ``load_checkpoint``: every leaf bit for bit."""
    jp, js, _, _ = _run(name, net)
    jstate = {"step": jnp.asarray(N_STEPS, jnp.int32), "params": jp,
              "batch_stats": net["stats"], "opt_state": js}
    j_save(tmp_path / "jax.msgpack", jstate)
    model = TNet()
    tx = build_optimizer(name, 1e-2, **KWARGS.get(name, {}))
    params = dict(model.named_parameters())
    state = TrainState(0, params, {}, tx.init(
        {k: p.detach() for k, p in params.items()}), model)
    tckpt.load_checkpoint(tmp_path / "jax.msgpack", state)
    assert state.step == N_STEPS
    codec.save_checkpoint(tmp_path / "port.msgpack", tckpt.state_to_jax(state))
    back = j_load(tmp_path / "port.msgpack", jstate)
    want = _leaves(fser.to_state_dict(jax.tree.map(np.asarray, jstate)))
    got = _leaves(fser.to_state_dict(jax.tree.map(np.asarray, back)))
    assert set(got) == set(want)
    for k, ref in want.items():
        if ref is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == ref.dtype and np.array_equal(got[k], ref), k


def _probe(params, key):
    """JAX's Rademacher draw of ``make_adahessian_loss_update``."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        jax.random.rademacher(k, leaf.shape, dtype=leaf.dtype)
        for k, leaf in zip(keys, leaves)])


def _grad_fn(tloss):
    def grad_fn(ps):
        keys = list(ps)
        g = torch.autograd.grad(tloss(ps), [ps[k] for k in keys],
                                create_graph=True)
        return dict(zip(keys, g))
    return grad_fn


def test_adahessian_trace_matches_jax(net):
    z = _probe(net["params"], jax.random.PRNGKey(3))
    want = _leaves(jax.tree.map(np.asarray, j_trace(
        jax.grad(net["jloss"]), net["params"], z)))
    got = adahessian_trace(_grad_fn(net["tloss"]), _port(net["params"]),
                           _port(z))
    # the bridge lays the traces out as the params (a rank-4 kernel's
    # block average is [out, in, 1, 1], flax's [1, 1, in, out])
    got = _leaves(params_to_jax({**net["model"].state_dict(), **got})[0])
    assert set(got) == set(want)
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        assert np.max(np.abs(got[k] - ref)) <= 1e-5 * np.max(np.abs(ref)), k


# Adahessian's step on a leaf whose |Hz| has entries near zero (the
# smallest under 1e-3 of the largest): the step divides by |Hz|'s square
# root, so fp32 rounding in |Hz| moves it by up to a few 1e-2 of the
# leaf's largest step. Measured on the 1-D conv kernel (smallest |Hz|
# 2.4e-5 of the largest): JAX's fp32 step 1.57e-2 from its float64 step
# (the bar is three times it), the port's fp32 step 2.36e-2 from it, the
# port's float64 step 3.5e-6 from it (the port rounds the bias
# corrections to fp32 as jitted JAX does)
AH_NEAR_ZERO = 1e-3
AH_FROM_F64 = 1.57e-2
AH_F64_BAR = 1e-5


def test_adahessian_loss_update_matches_jax(net):
    """One true second-order step: the loss to 1e-6, the state and the
    parameter step to 1e-5 of their largest value; on a leaf whose |Hz|
    comes near zero (``AH_NEAR_ZERO``), where the step misses 1e-5,
    JAX's own float64 step (the same probe) decides: the port's float64
    step is held to it to ``AH_F64_BAR``, JAX's fp32 step to three times
    ``AH_FROM_F64``, and the port's fp32 step to twice JAX's distance."""
    kw = {"weight_decay": 1e-3}
    jtx = j_build("Adahessian", 1e-2, **kw)
    key = jax.random.PRNGKey(5)
    jp, js, jl = j_make_step(net["jloss"], jtx)(
        net["params"], jtx.init(net["params"]), key)
    zj = _probe(net["params"], key)
    z = _port(zj)
    tp0 = _port(net["params"])

    def port_step(dtype):
        ttx = build_optimizer("Adahessian", 1e-2, **kw)
        model = net["model"].to(dtype)
        p0 = {k: v.to(dtype, copy=True) for k, v in tp0.items()}
        out = make_adahessian_loss_update(
            lambda p: net["tloss"]({k: v.to(torch.float32) for k, v in
                                    p.items()}) if dtype == torch.float32
            else _loss64(model, p, net), ttx)(
            p0, ttx.init(p0), [{k: v.to(dtype) for k, v in z.items()}])
        model.float()
        return out

    tp, ts, tl = port_step(torch.float32)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    hz = _port(j_trace(jax.grad(net["jloss"]), net["params"], zj))
    want = _port(jp)
    box = {}
    for k, ref in want.items():
        got, ref = (tp[k] - tp0[k]).numpy(), (ref - tp0[k]).numpy()
        scale = np.max(np.abs(ref))
        err = np.max(np.abs(got - ref))
        if err <= 1e-5 * scale:
            continue
        h = hz[k].abs()
        assert float(h.min()) < AH_NEAR_ZERO * float(h.max()), \
            f"{k}: max err {err:.3e} > 1e-5 * {scale:.3e}"
        if not box:
            box["jax"] = _jax_adahessian_f64(net, jtx, zj)
            box["port"] = port_step(torch.float64)[0]
        u64 = box["jax"][k].double().numpy()
        d_jax = np.max(np.abs(ref - u64))
        assert np.max(np.abs((box["port"][k] - tp0[k].double()).numpy()
                             - u64)) <= AH_F64_BAR * scale, k
        assert d_jax <= 3 * AH_FROM_F64 * scale, k
        assert np.max(np.abs(got - u64)) <= 2 * d_jax, k
    sd = {**net["model"].state_dict(), **tp}
    got = _leaves(tckpt._opt_to_jax(ts, sd))
    want_s = _leaves(fser.to_state_dict(jax.tree.map(np.asarray, js)))
    assert set(got) == set(want_s)
    for k, ref in want_s.items():
        if ref is not None:
            assert got[k].shape == ref.shape, k
            assert np.max(np.abs(got[k] - ref)) <= 1e-5 * max(
                np.max(np.abs(ref)), 1e-30), k


def _jax_adahessian_f64(net, jtx, z):
    """JAX's Adahessian step in float64 (params, batch stats, probe),
    as the port's parameter tree of float64 steps."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(       # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        params = f64(net["params"])
        jloss = _jax_loss(net["x"], net["label"], f64(net["stats"]))
        grad_fn = jax.grad(jloss)
        u, _ = jtx.update(grad_fn(params), jtx.init(params), params,
                          hessian=j_trace(grad_fn, params, f64(z)))
        flat = {k: np.asarray(v) for k, v in flatten_dict(u).items()}
    # the bridge carries float32: lay the float64 steps out by its rules
    return {k: from_flax(k, torch.from_numpy(flat[flax_path(k, v.dim())]))
            for k, v in _port(net["params"]).items()}


def _loss64(model, p, net):
    buffers = {k: b.double() if b.is_floating_point() else b
               for k, b in model.named_buffers()}
    x = torch.from_numpy(net["x"]).double()
    logits = torch.func.functional_call(model, {**p, **buffers}, (x,))
    return F.cross_entropy(logits, torch.from_numpy(net["label"]))


def test_lookahead_hands_no_hessian_to_its_inner_optimizer():
    """JAX's Lookahead is a plain transformation: optax drops
    ``hessian=`` before it, so over Adahessian it steps with ``|grad|``,
    and so does the port's."""
    p, g, h = [1.0, -2.0, 3.0], [0.5, 0.1, -0.2], [10.0, 10.0, 10.0]
    tx = build_optimizer("Lookahead", 1e-2, inner="Adahessian")
    tp = {"a": torch.tensor(p)}
    with_h, _ = tx.update({"a": torch.tensor(g)}, tx.init(tp), tp,
                          hessian={"a": torch.tensor(h)})
    without, _ = tx.update({"a": torch.tensor(g)}, tx.init(tp), tp)
    assert torch.equal(with_h["a"], without["a"])
    jtx = j_build("Lookahead", 1e-2, inner="Adahessian")
    jp = {"a": jnp.asarray(p)}
    want, _ = jtx.update({"a": jnp.asarray(g)}, jtx.init(jp), jp,
                         hessian={"a": jnp.asarray(h)})
    np.testing.assert_allclose(with_h["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)
