"""The port's optimizers and schedules against the JAX package's (CPU).

Optimizers: 20 steps on one fixed stream of gradients (decaying from 1 to
1e-3) with a learning rate changed every step through the injected
hyperparameter; parameters agree to 1e-6 of their largest value. The
JAX update is jitted, as the train step runs it (eager XLA computes
``b2 ** count`` another way, a float ulp away). The optimizer state's
layout is optax's as flax serializes it.

Shampoo's 1-D leaf is chaotic in fp32: its preconditioner is ε·I (ε
1e-4) plus rank-one terms, whose inverse amplifies rounding by up to
1/ε, so after 20 steps either package's fp32 run is far from a float64
one (measured: JAX's 0.229 of the leaf's largest value, the port's
0.143). There alone, where the leaf misses 1e-6, JAX's own float64 run
decides: the port's float64 run is held to it to 1e-6 (measured
1.4e-9), JAX's fp32 distance from it to three times the measured
0.229, and the port's fp32 distance from it to twice JAX's."""

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speakerverification_tpu.optim import build_optimizer as j_build
from speakerverification_tpu.optim import build_scheduler as j_sched
from speakerverification_tpu.optim import (
    EarlyStopping as JEarly,
    ReduceOnPlateau as JPlateau,
    get_ema_params as j_get_ema,
    set_learning_rate as j_set_lr,
)
from speakerverification_tpu_torch.optim import (
    EarlyStopping,
    ReduceOnPlateau,
    apply_updates,
    build_optimizer,
    build_scheduler,
    set_learning_rate,
)

OPTIMIZERS = [
    ("AdaBelief", {"weight_decay": 2e-5}),
    ("AdaBelief", {"weight_decay": 2e-5, "rectify": True}),
    ("AdaBelief", {"weight_decay": 1e-2, "weight_decouple": True}),
    ("AdaBelief", {"weight_decay": 1e-2, "weight_decouple": True,
                   "fixed_decay": True}),
    ("adam", {"weight_decay": 1e-4}),
    ("adam", {}),
    ("sgd", {"weight_decay": 1e-4, "momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {}),
    ("AdaBelief", {"weight_decay": 2e-5, "ema_decay": 0.9}),
    ("SGDW", {"weight_decay": 1e-2}),
    ("SGDW", {"momentum": 0.9, "nesterov": True}),
    ("QHM", {"weight_decay": 1e-4, "momentum": 0.9}),
    ("QHAdam", {"nu1": 0.7, "weight_decay": 1e-4}),
    ("DiffGrad", {"weight_decay": 1e-4}),
    ("MADGRAD", {"weight_decay": 1e-4}),
    ("MADGRAD", {"momentum": 0.0}),
    ("AdaBound", {"weight_decay": 1e-4}),
    ("AdaMod", {"weight_decay": 1e-4}),
    ("AdamP", {"weight_decay": 1e-2}),
    ("AdamP", {"nesterov": True}),
    ("SGDP", {"weight_decay": 1e-2}),
    ("AggMo", {"weight_decay": 1e-4}),
    ("PID", {"momentum": 0.9, "weight_decay": 1e-4}),
    ("PID", {}),
    ("AccSGD", {"weight_decay": 1e-4}),
    ("SWATS", {"weight_decay": 1e-4}),
    ("RAdam", {"weight_decay": 1e-4}),
    ("Lamb", {"weight_decay": 1e-2}),
    ("Lamb", {"debias": True}),
    ("LARS", {"weight_decay": 1e-4, "momentum": 0.9}),
    ("NovoGrad", {"weight_decay": 1e-4}),
    ("Adafactor", {"weight_decay": 1e-2}),
    ("Adafactor", {"relative_step": False, "beta1": 0.9}),
    ("Yogi", {"weight_decay": 1e-4}),
    ("Lookahead", {}),
    ("Lookahead", {"inner": "AdaBelief", "k": 3,
                   "inner_kwargs": {"rectify": True}}),
    ("Adahessian", {"weight_decay": 1e-4}),
    ("Shampoo", {"momentum": 0.9, "weight_decay": 1e-4}),
    ("Apollo", {"warmup": 5, "weight_decay": 1e-4}),
    ("A2GradUni", {}),
]


def _problem():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
              "b": rng.normal(0, 0.1, (7,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32)
              for k, v in params.items()}
             for s in np.geomspace(1, 1e-3, 20)]
    return params, grads


def _port_run(tx, params, grads, dtype):
    tp = {k: torch.from_numpy(v.copy()).to(dtype) for k, v in params.items()}
    ts = tx.init(tp)
    for i, g in enumerate(grads):
        ts = set_learning_rate(ts, 1e-3 * (1 - i / 40))
        u, ts = tx.update({k: torch.from_numpy(v).to(dtype)
                           for k, v in g.items()}, ts, tp)
        apply_updates(tp, u)
    return tp, ts


def _jax_run(name, kw, params, grads, dtype):
    jtx = j_build(name, 1e-3, **kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    js = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    for i, g in enumerate(grads):
        js = j_set_lr(js, jnp.asarray(1e-3 * (1 - i / 40), dtype))
        u, js = jupdate(jax.tree.map(lambda a: jnp.asarray(a, dtype), g),
                        js, jp)
        jp = optax.apply_updates(jp, u)
    return jp, js


# Shampoo's 1-D leaf: JAX's fp32 distance from its float64 run, of the
# leaf's largest value (measured; the bar is three times it)
SHAMPOO_1D_FROM_F64 = 0.229


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(k)}" for n, k in OPTIMIZERS])
def test_trajectory_matches_optax(name, kw):
    params, grads = _problem()
    jp, js = _jax_run(name, kw, params, grads, jnp.float32)
    tp, ts = _port_run(build_optimizer(name, 1e-3, **kw), params, grads,
                       torch.float32)
    for k in params:
        ref = np.asarray(jp[k])
        scale = np.max(np.abs(ref))
        err = np.max(np.abs(tp[k].numpy() - ref))
        if err <= 1e-6 * scale:
            continue
        assert name == "Shampoo" and params[k].ndim == 1, \
            f"{k}: max err {err:.3e} > 1e-6 * {scale:.3e}"
        with jax.enable_x64(True):
            j64 = np.asarray(_jax_run(name, kw, params, grads,
                                      jnp.float64)[0][k])
        t64 = _port_run(build_optimizer(name, 1e-3, **kw), params, grads,
                        torch.float64)[0][k].numpy()
        d_jax = np.max(np.abs(ref - j64))
        assert np.max(np.abs(t64 - j64)) <= 1e-6 * scale, k
        assert d_jax <= 3 * SHAMPOO_1D_FROM_F64 * scale, k
        assert np.max(np.abs(tp[k].numpy() - j64)) <= 2 * d_jax, k
    if kw.get("ema_decay"):
        ema = ts[1]["ema"]          # track_ema, chained after the optimizer
        for k in params:
            ref = np.asarray(j_get_ema(js)[k])
            assert np.max(np.abs(ema[k].numpy() - ref)) <= 1e-6 * np.max(
                np.abs(ref))


def _state_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_state_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (np.shape(tree), np.asarray(tree).dtype.name)}


@pytest.mark.parametrize("name,kw", [("AdaBelief", {"weight_decay": 2e-5}),
                                     ("adam", {"weight_decay": 1e-4}),
                                     ("sgd", {"momentum": 0.9}),
                                     ("AdaBelief", {"ema_decay": 0.999})])
def test_state_layout_is_optax_serialized(name, kw):
    """The port's optimizer state, as its checkpoints write it, has the
    keys, shapes and dtypes of ``flax.serialization.to_state_dict`` of
    the JAX optimizer's state (``inject_hyperparams``: count,
    hyperparams.learning_rate, hyperparams_states, inner_state)."""
    from speakerverification_tpu_torch.checkpoint import _state_dict
    from speakerverification_tpu_torch.training.checkpoint import _opt_to_jax
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    tp = dict(model.named_parameters())
    ts = build_optimizer(name, 1e-3, **kw).init(
        {k: p.detach() for k, p in tp.items()})
    got = _state_dict(_opt_to_jax(ts, model.state_dict()))
    jparams = {"0": {"kernel": jnp.zeros((3, 2)), "bias": jnp.zeros((2,))}}
    want = fser.to_state_dict(j_build(name, 1e-3, **kw).init(jparams))
    assert _state_leaves(got) == _state_leaves(
        jax.tree.map(np.asarray, want))


def test_build_optimizer_warns_on_unknown_keys_and_checks_ema():
    with pytest.warns(UserWarning, match="ignores config key"):
        build_optimizer("adam", 1e-3, betas=(0.9, 0.99))
    with pytest.raises(ValueError, match="ema_decay"):
        build_optimizer("adam", 1e-3, ema_decay=1.5)
    with pytest.raises(KeyError, match="registered"):
        build_optimizer("NoSuchOptimizer", 1e-3)


@pytest.mark.parametrize("name,kw", [
    ("cosine_annealinglr_pt", {"T_max": 7, "eta_min": 1e-8}),
    ("steplr", {"step_size": 3, "lr_decay": 0.9}),
    ("cosine_annealinglr_cus", {"T_max": 7}),
    ("cosine_annealing_warm_restarts", {"T_max": 5, "T_mult": 2}),
    ("cycliclr", {"T_max": 8, "max_lr": 3e-3})])
def test_schedule_values_match(name, kw):
    jf, junit = j_sched(name, 3e-3, **kw)
    tf, tunit = build_scheduler(name, 3e-3, **kw)
    assert junit == tunit
    for t in range(40):
        assert tf(t) == jf(t)


def test_cosine_is_periodic_past_t_max():
    sched, unit = build_scheduler("cosine_annealinglr_pt", 3e-3, T_max=10,
                                  eta_min=1e-8)
    assert unit == "iteration"
    assert sched(0) == pytest.approx(3e-3)
    assert sched(10) == pytest.approx(1e-8)
    assert sched(20) == pytest.approx(3e-3)


def test_plateau_and_early_stopping_match():
    losses = [5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 3.9, 4.0, 4.0, 4.0, 4.0, 4.1]
    jp, tp = JPlateau(1e-3, patience=2), ReduceOnPlateau(1e-3, patience=2)
    je, te = JEarly(patience=3), EarlyStopping(patience=3)
    for x in losses:
        assert tp(x) == jp(x)
        assert te(x) == je(x)


@pytest.mark.parametrize("callbacks", [
    {"name": "cosine_annealinglr_pt", "base_lr": 1e-8, "max_lr": 0.003},
    {"name": "steplr", "step_size": 2},
    {"name": "reduceOnPlateau", "step_size": 1, "base_lr": 1e-5}])
def test_builder_schedule_and_optimizer_match(callbacks):
    """``scheduler_from_hparams`` / ``optimizer_from_hparams`` on the
    default yaml with each callback, against the JAX builder's."""
    from pathlib import Path
    from speakerverification_tpu import builder as JB
    from speakerverification_tpu.config import read_config
    from speakerverification_tpu_torch import builder as TB
    h = read_config(Path(__file__).resolve().parents[1] / "yaml" /
                    "raw3_ecapa.yaml")
    h["callbacks"] = callbacks
    (js, ju), (ts, tu) = (JB.scheduler_from_hparams(h, 7),
                          TB.scheduler_from_hparams(h, 7))
    assert ju == tu
    if tu == "plateau":
        for loss in (3.0, 3.1, 3.2, 2.0, 2.5, 2.6):
            assert ts(loss) == js(loss)
    else:
        assert [ts(t) for t in range(20)] == [js(t) for t in range(20)]
    state = TB.optimizer_from_hparams(h).init({"w": torch.zeros(2)})
    assert float(state["hyperparams"]["learning_rate"]) == \
        pytest.approx(h["lr"])
    assert set(state["inner_state"]) == {"count", "m", "v"}   # AdaBelief
