"""Optimizers (port of ``optim/__init__.py``) as plain functions over
parameter dicts, with the optax semantics the JAX package trains with.

An optimizer is a :class:`GradientTransformation`: ``init(params) ->
state`` and ``update(grads, state, params) -> (updates, state)``, where
``params``, ``grads`` and ``updates`` map the port's parameter names to
tensors, and the step adds ``updates`` to the parameters. The state
keeps optax's structure as flax serializes it, so that the checkpoints
hold what the JAX optimizer's state holds:

* a tuple for ``optax.chain`` (stored with index keys ``"0"``, ``"1"``…);
* ``{}`` for a stateless transformation;
* a :class:`ParamTree` where optax keeps a tree shaped like the params
  (moments, EMA); ``training/checkpoint.py`` writes it in flax layout;
* a :class:`LeafTree` where the JAX optimizer keeps a tree keyed by
  parameter whose leaves have other shapes (Adafactor's factored
  moments, Shampoo's per-axis matrices, per-leaf scalars and flags):
  its leaves are already in flax layout and are written as they are,
  at each parameter's flax path;
* a Python ``int`` for a step count (int32 in the file) and a
  ``numpy.float32`` for the learning rate.

:func:`build_optimizer` injects the learning rate as optax's
``inject_hyperparams`` does: ``{"count", "hyperparams":
{"learning_rate"}, "hyperparams_states": {}, "inner_state"}``, the inner
optimizer rebuilt from the state's learning rate at every update, every
other argument fixed. ``ema_decay > 0`` chains :func:`track_ema` after it.
Extra keyword arguments of ``update`` (Adahessian's ``hessian=``) reach
the transformations that take them, as optax's ``*ExtraArgs`` do;
Lookahead, a plain transformation in JAX, takes none and hands none to
its inner optimizer.

Where an optimizer's arithmetic depends on the layout (AdamP, SGDP,
Adafactor, Shampoo), each leaf is viewed in flax layout
(:func:`to_flax`, the weight bridge's axis rules), and where it runs
through the leaves in order (SWATS), the order is JAX's: the sorted
flax paths (:func:`flax_order`). The optimizers beyond adam and sgd
live in ``optim/custom.py`` and ``optim/second_order.py``.

Weight decay is coupled (``g + wd·p`` before the moments, torch's
``Adam(weight_decay=…)``) where the reference couples it.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from speakerverification_tpu_torch.registry import OPTIMIZERS
from speakerverification_tpu_torch.weights import flax_axes, flax_path

__all__ = ["GradientTransformation", "ParamTree", "LeafTree", "OPTIMIZERS",
           "chain", "build_optimizer", "set_learning_rate", "track_ema",
           "apply_updates", "adam", "sgd", "yogi", "lookahead",
           "to_flax", "from_flax", "flax_order",
           "build_scheduler", "ReduceOnPlateau", "EarlyStopping"]


class GradientTransformation(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple]


class ParamTree(dict):
    """Optimizer state shaped like the parameters: parameter name →
    tensor, in the port's layout."""


class LeafTree(dict):
    """Optimizer state keyed by parameter name whose leaves are not
    shaped like the parameter (a tensor of another shape, a 0-d tensor,
    or a tuple of tensors), in flax layout."""


def to_flax(key: str, t: torch.Tensor) -> torch.Tensor:
    """The parameter ``key``'s tensor (or a tensor shaped like it) viewed
    in flax layout."""
    return t.permute(flax_axes(key, t.dim()))


def from_flax(key: str, t: torch.Tensor) -> torch.Tensor:
    """:func:`to_flax`'s inverse, contiguous."""
    perm = flax_axes(key, t.dim())
    inv = [0] * len(perm)
    for i, a in enumerate(perm):
        inv[a] = i
    return t.permute(inv).contiguous()


def flax_order(params: dict) -> list:
    """The keys of ``params`` in JAX's flatten order of the flax tree
    (its paths sorted)."""
    return sorted(params, key=lambda k: flax_path(k, params[k].dim()))


def zeros_like(params: dict) -> ParamTree:
    return ParamTree({k: torch.zeros_like(p, memory_format=torch.
                                          contiguous_format)
                      for k, p in params.items()})


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (what a jnp scalar of the
    JAX optimizer holds)."""
    return float(np.float32(x))


def _pow(base: float, count: int) -> float:
    """``base ** count`` in fp32, as jnp computes a Python float to the
    power of an int32 step count."""
    return float(np.float32(base) ** np.float32(count))


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: {},
                                  lambda u, state, params=None: (u, state))


def _update(tx: GradientTransformation, updates, state, params, extra):
    """``tx.update`` with those of the ``extra`` keyword arguments it
    takes."""
    if extra:
        sig = inspect.signature(tx.update).parameters
        if not any(p.kind is p.VAR_KEYWORD for p in sig.values()):
            extra = {k: v for k, v in extra.items() if k in sig}
    return tx.update(updates, state, params, **extra)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None, **extra):
        new = []
        for tx, s in zip(txs, state):
            updates, s = _update(tx, updates, s, params, extra)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def _foreach(fn, *trees: dict) -> dict:
    """``fn`` over the trees' values as lists (``torch._foreach_*``)."""
    keys = list(trees[0])
    out = fn(*([t[k] for k in keys] for t in trees))
    return dict(zip(keys, out))


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return _foreach(lambda g, p: torch._foreach_add(
            g, torch._foreach_mul(p, weight_decay)), updates, params), state
    return GradientTransformation(lambda params: {}, update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return _foreach(lambda g: torch._foreach_mul(g, step_size),
                        updates), state
    return GradientTransformation(lambda params: {}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": zeros_like(params),
                "nu": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g = [updates[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(
                                    [state["mu"][k] for k in keys], b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul([state["nu"][k] for k in keys], b2))
        count = state["count"] + 1
        bc1 = _f32(1 - np.float32(_pow(b1, count)))
        bc2 = _f32(1 - np.float32(_pow(b2, count)))
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), eps)
        out = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        return dict(zip(keys, out)), {
            "count": count, "mu": ParamTree(zip(keys, mu)),
            "nu": ParamTree(zip(keys, nu))}

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return {"trace": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g = [updates[k] for k in keys]
        new = torch._foreach_add(g, torch._foreach_mul(
            [state["trace"][k] for k in keys], decay))
        out = (torch._foreach_add(g, torch._foreach_mul(new, decay))
               if nesterov else new)
        return dict(zip(keys, out)), {"trace": ParamTree(zip(keys, new))}

    return GradientTransformation(init, update)


def apply_updates(params: dict, updates: dict) -> None:
    """``p += u`` for every parameter, in place."""
    with torch.no_grad():
        keys = list(params)
        torch._foreach_add_([params[k] for k in keys],
                            [updates[k] for k in keys])


def track_ema(decay: float) -> GradientTransformation:
    """An exponential moving average of the post-update parameters, kept
    in the optimizer state (``{"ema": ParamTree}``); chain it last, so
    that ``params + updates`` is the new point."""
    def init(params):
        return {"ema": ParamTree({k: p.detach().clone()
                                  for k, p in params.items()})}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("track_ema requires params in update")
        keys = list(params)
        new_p = torch._foreach_add([params[k].detach() for k in keys],
                                   [updates[k] for k in keys])
        ema = torch._foreach_add(
            torch._foreach_mul([state["ema"][k] for k in keys], decay),
            torch._foreach_mul(new_p, 1.0 - decay))
        return updates, {"ema": ParamTree(zip(keys, ema))}

    return GradientTransformation(init, update)


def _l2(weight_decay: float) -> GradientTransformation:
    """Coupled (torch-style) L2: grad += wd * param, before moments."""
    return add_decayed_weights(weight_decay) if weight_decay else identity()


@OPTIMIZERS.register("adam", aliases=("Adam",))
def adam(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, **kw):
    return chain(_l2(weight_decay), scale_by_adam(b1, b2, eps),
                 scale(-_f32(learning_rate)))


@OPTIMIZERS.register("sgd", aliases=("SGD",))
def sgd(learning_rate, weight_decay=0.0, momentum=0.0, nesterov=False, **kw):
    return chain(_l2(weight_decay),
                 trace(momentum, nesterov) if momentum else identity(),
                 scale(-_f32(learning_rate)))


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
                  initial_accumulator_value: float = 1e-6
                  ) -> GradientTransformation:
    """``optax.scale_by_yogi``: moments seeded at 1e-6, the second one
    moved by ``(1 − b2)·sign(v − g²)·g²``."""
    def init(params):
        return {"count": 0,
                "mu": ParamTree({k: torch.full_like(
                    p, initial_accumulator_value) for k, p in params.items()}),
                "nu": ParamTree({k: torch.full_like(
                    p, initial_accumulator_value) for k, p in params.items()})}

    def update(updates, state, params=None):
        keys = list(updates)
        g = [updates[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(
                                    [state["mu"][k] for k in keys], b1))
        v = [state["nu"][k] for k in keys]
        g2 = torch._foreach_mul(g, g)
        nu = torch._foreach_sub(v, torch._foreach_mul(torch._foreach_mul(
            torch._foreach_sign(torch._foreach_sub(v, g2)), 1 - b2), g2))
        count = state["count"] + 1
        bc1 = _f32(1 - np.float32(_pow(b1, count)))
        bc2 = _f32(1 - np.float32(_pow(b2, count)))
        out = torch._foreach_div(
            torch._foreach_div(mu, bc1), torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps))
        return dict(zip(keys, out)), {
            "count": count, "mu": ParamTree(zip(keys, mu)),
            "nu": ParamTree(zip(keys, nu))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("Yogi")
def yogi(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-3, **kw):
    return chain(_l2(weight_decay), scale_by_yogi(b1, b2, eps),
                 scale(-_f32(learning_rate)))


def _lookahead(inner: GradientTransformation, k: int,
               alpha: float) -> GradientTransformation:
    """Lookahead with the slow weights in its own state (``{"inner",
    "slow", "counter", "has_slow"}``, JAX's ``LookaheadState``): the sync
    runs when the counter is 0, the first step included (where it seeds
    the slow weights from the fast ones), as ``alpha·fast + (1 −
    alpha)·slow``, and the slow weights become the result."""
    def init(params):
        return {"inner": inner.init(params), "slow": zeros_like(params),
                "counter": 0, "has_slow": False}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("Lookahead requires params in update")
        u, inner_state = inner.update(updates, state["inner"], params)
        keys = list(params)
        p = [params[k].detach() for k in keys]
        fast = torch._foreach_add(p, [u[k] for k in keys])
        slow = ([state["slow"][k] for k in keys] if state["has_slow"]
                else fast)
        if state["counter"] == 0:
            out = torch._foreach_add(torch._foreach_mul(fast, alpha),
                                     torch._foreach_mul(slow, 1 - alpha))
            slow = out
        else:
            out = fast
        return dict(zip(keys, torch._foreach_sub(out, p))), {
            "inner": inner_state,
            "slow": ParamTree(zip(keys, slow)),
            "counter": (state["counter"] + 1) % k, "has_slow": True}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("Lookahead")
def lookahead(learning_rate, weight_decay=0.0, k=5, alpha=0.5,
              inner: str = "adam", inner_kwargs=None, **kw):
    """Lookahead around the optimizer ``inner`` (built with
    ``inner_kwargs``, a named key so that a config reaches it)."""
    fast = OPTIMIZERS.get(inner)(learning_rate, weight_decay,
                                 **dict(inner_kwargs or {}))
    return _lookahead(fast, k=int(k), alpha=float(alpha))


from speakerverification_tpu_torch.optim import custom  # noqa: E402,F401
from speakerverification_tpu_torch.optim import second_order  # noqa: E402,F401
from speakerverification_tpu_torch.optim.schedulers import (  # noqa: E402
    EarlyStopping,
    ReduceOnPlateau,
    build_scheduler,
)


def _inject(factory: Callable, learning_rate: float,
            static: dict) -> GradientTransformation:
    def init(params):
        lr = np.float32(learning_rate)
        return {"count": 0, "hyperparams": {"learning_rate": lr},
                "hyperparams_states": {},
                "inner_state": factory(learning_rate=lr, **static)
                .init(params)}

    def update(updates, state, params=None, **extra):
        lr = state["hyperparams"]["learning_rate"]
        updates, inner = _update(factory(learning_rate=lr, **static),
                                 updates, state["inner_state"], params, extra)
        return updates, {**state, "count": state["count"] + 1,
                         "inner_state": inner}

    return GradientTransformation(init, update)


def build_optimizer(name: str, learning_rate: float,
                    weight_decay: float = 0.0, lr_decay: float | None = None,
                    ema_decay: float = 0.0, **kwargs) -> GradientTransformation:
    """The optimizer registered as ``name`` with an injected learning
    rate (:func:`set_learning_rate`). ``lr_decay`` is accepted for config
    parity (the schedulers use it); config keys the factory does not take
    are dropped with a warning. ``ema_decay > 0`` chains
    :func:`track_ema` after it."""
    factory = OPTIMIZERS.get(name)
    accepted = set(inspect.signature(factory).parameters)
    clean = {k: v for k, v in kwargs.items()
             if k in accepted and k not in ("learning_rate", "weight_decay")}
    dropped = set(kwargs) - set(clean) - {"learning_rate", "weight_decay"}
    if dropped:
        warnings.warn(f"optimizer {name!r} ignores config key(s) "
                      f"{sorted(dropped)}; accepted: "
                      f"{sorted(accepted - {'kw', 'kwargs'})}",
                      stacklevel=2)
    tx = _inject(factory, learning_rate,
                 {"weight_decay": weight_decay, **clean})
    if ema_decay:
        if not 0.0 < float(ema_decay) < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        tx = chain(tx, track_ema(float(ema_decay)))
    return tx


def set_learning_rate(opt_state, lr):
    """The optimizer state with its injected learning rate set to ``lr``
    (a bare injected state, or the chain that ``ema_decay`` makes)."""
    if isinstance(opt_state, dict):
        return {**opt_state, "hyperparams": {
            **opt_state["hyperparams"], "learning_rate": np.float32(lr)}}
    return (set_learning_rate(opt_state[0], lr),) + tuple(opt_state[1:])
