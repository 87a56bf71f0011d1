"""Second-order and quasi-Newton optimizers (port of
``optim/second_order.py``): ``Adahessian``, ``Shampoo``, ``Apollo`` and
``A2GradUni``, and the Hessian helpers of Adahessian.

* ``Adahessian``: Adam over an estimate of the Hessian diagonal, the
  denominator ``v^(k/2) / bc2^(k/2) + eps`` (``hessian_power`` k), the
  decay coupled inside the rate. Its ``update`` takes the estimate as
  ``hessian=``; without one it uses ``|grad|``, which is what the train
  step gives it (the JAX step does the same). The true second-order step
  is :func:`make_adahessian_loss_update`: the gradients and the
  Hutchinson trace :func:`adahessian_trace` (``|Hz|`` for a Rademacher
  ``z``, averaged over the spatial block of a rank-4 kernel), its
  Hessian-vector products by double backward.
* ``Shampoo``: one preconditioner per flax axis of each leaf (any rank),
  seeded at ``epsilon·I``, applied axis after axis with the inverse
  ``order``-th root (by SVD, as the reference), the momentum buffer
  holding the preconditioned gradient. At the default stack's 13,103
  classes the head's class axis gives a 13,103² matrix and one SVD of it
  per step.
* ``Apollo``: a diagonal quasi-Newton step with the curvature rectified
  at ``|B| ≥ 1``.
* ``A2GradUni``: the uniform-averaging adaptive accelerated gradient
  (the learning rate is not used).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from speakerverification_tpu_torch.optim import (
    GradientTransformation,
    LeafTree,
    ParamTree,
    _f32,
    _pow,
    flax_axes,
    from_flax,
    to_flax,
    zeros_like,
)
from speakerverification_tpu_torch.registry import OPTIMIZERS

__all__ = ["hutchinson_hessian_diag", "adahessian_trace",
           "make_adahessian_loss_update", "rademacher"]


# --------------------------------------------------------------------------
# Adahessian
# --------------------------------------------------------------------------

def rademacher(params: dict, generator: torch.Generator) -> dict:
    """A ±1 probe shaped like each parameter, drawn from ``generator``
    (on the parameters' device)."""
    return {k: (torch.randint(0, 2, p.shape, generator=generator,
                              device=p.device) * 2 - 1).to(p.dtype)
            for k, p in params.items()}


def _hvp(grad_fn: Callable, params: dict, probes: Sequence[dict]) -> list:
    """``H·z`` for each probe ``z``, by double backward: ``grad_fn(ps)``
    returns the gradients of ``ps`` built with ``create_graph=True``."""
    ps = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    grads = grad_fn(ps)
    return _hvp_from(grads, ps, probes)


def _hvp_from(grads: dict, ps: dict, probes: Sequence[dict]) -> list:
    keys = list(ps)
    outs = []
    for i, z in enumerate(probes):
        hz = torch.autograd.grad([grads[k] for k in keys],
                                 [ps[k] for k in keys],
                                 grad_outputs=[z[k] for k in keys],
                                 retain_graph=i < len(probes) - 1,
                                 allow_unused=True)
        outs.append({k: torch.zeros_like(ps[k]) if h is None else h.detach()
                     for k, h in zip(keys, hz)})
    return outs


def hutchinson_hessian_diag(grad_fn: Callable, params: dict,
                            generator: torch.Generator,
                            n_probes: int = 1) -> dict:
    """``E[z ⊙ Hz]`` over ``n_probes`` Rademacher probes."""
    probes = [rademacher(params, generator) for _ in range(n_probes)]
    hzs = _hvp(grad_fn, params, probes)
    acc = None
    for z, hz in zip(probes, hzs):
        term = {k: z[k] * hz[k] for k in hz}
        acc = term if acc is None else {k: acc[k] + term[k] for k in acc}
    return {k: a / n_probes for k, a in acc.items()}


def _block_mean(key: str, a: torch.Tensor) -> torch.Tensor:
    """``a`` averaged over a rank-4 kernel's spatial axes (flax's 0 and 1,
    kept), as the reference averages its Hessian diagonal."""
    if a.dim() != 4:
        return a
    perm = flax_axes(key, 4)
    return a.mean(dim=(perm[0], perm[1]), keepdim=True)


def adahessian_trace(grad_fn: Callable, params: dict, z: dict) -> dict:
    """The reference's Hutchinson trace: ``|Hz|`` per leaf for the ±1
    probe ``z``, block-averaged for rank-4 kernels (the reference dies on
    rank-3 ones; they get plain ``|Hz|``, as in JAX)."""
    (hz,) = _hvp(grad_fn, params, [z])
    return {k: _block_mean(k, torch.abs(h)) for k, h in hz.items()}


@OPTIMIZERS.register("Adahessian")
def adahessian(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999,
               eps=1e-4, hessian_power=0.5, **kw):
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params=None, *, hessian=None):
        keys = list(updates)
        count = state["count"] + 1
        bc1 = _f32(1 - np.float32(_pow(b1, count)))
        bc2 = _f32(1 - np.float32(_pow(b2, count)))
        bc2_k = _f32(np.float32(np.sqrt(np.float32(bc2)))
                     ** np.float32(hessian_power))
        m, v, out = {}, {}, {}
        for k in keys:
            g = updates[k]
            h = torch.abs(g) if hessian is None else hessian[k]
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * h * h
            p = (torch.zeros_like(g) if params is None
                 else params[k].detach())
            denom = torch.pow(torch.sqrt(v[k]), hessian_power) / bc2_k + eps
            out[k] = -_f32(lr) * ((m[k] / bc1) / denom + weight_decay * p)
        return out, {"count": count, "m": ParamTree(m), "v": ParamTree(v)}

    return GradientTransformation(init, update)


def make_adahessian_loss_update(loss_fn: Callable, tx, n_probes: int = 1):
    """The true second-order step: ``loss_fn(params) -> scalar`` (params
    a dict of tensors); returns ``step(params, opt_state, rng) ->
    (params, opt_state, loss)``, which takes the gradients and the mean
    of ``n_probes`` Hutchinson traces from one forward (double backward
    for the Hessian-vector products) into ``tx.update(...,
    hessian=...)``. ``rng`` is a ``torch.Generator`` the probes are drawn
    from, or the probes themselves (a list of ``n_probes`` ±1 trees)."""
    def step(params, opt_state, rng):
        ps = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = loss_fn(ps)
        keys = list(ps)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [ps[k] for k in keys], create_graph=True)))
        probes = (list(rng) if not isinstance(rng, torch.Generator)
                  else [rademacher(ps, rng) for _ in range(n_probes)])
        if len(probes) != n_probes:
            raise ValueError(f"{len(probes)} probes for n_probes={n_probes}")
        hess = None
        for hz in _hvp_from(grads, ps, probes):
            tr = {k: _block_mean(k, torch.abs(h)) for k, h in hz.items()}
            hess = tr if hess is None else {k: hess[k] + tr[k] for k in tr}
        if n_probes > 1:
            hess = {k: h / n_probes for k, h in hess.items()}
        plain = {k: p.detach() for k, p in params.items()}
        updates, opt_state = tx.update(
            {k: g.detach() for k, g in grads.items()}, opt_state, plain,
            hessian=hess)
        return ({k: plain[k] + updates[k] for k in keys}, opt_state,
                loss.detach())

    return step


# --------------------------------------------------------------------------
# Shampoo
# --------------------------------------------------------------------------

def _inv_pth_root(mat: torch.Tensor, p: float) -> torch.Tensor:
    """``mat^(−1/p)`` by SVD (``u · s^(−1/p) · vᵀ``), as the
    reference."""
    u, s, vt = torch.linalg.svd(mat)
    return (u * torch.pow(torch.clamp(s, min=1e-30), -1.0 / p)) @ vt


def _shampoo_leaf(g, p, bf, pre, inv, first, count, lr, momentum,
                  weight_decay, update_freq):
    """One leaf in flax layout: ``(update, buffer, preconds, inverses)``."""
    order = g.dim()
    if momentum > 0:
        g = (1 - momentum) * g + momentum * (g if first else bf)
    if weight_decay > 0 and p is not None:
        g = g + weight_decay * p
    new_pre, new_inv = [], []
    original_shape = g.shape
    for dim_id in range(order):
        perm = list(range(order))
        perm[0], perm[dim_id] = perm[dim_id], perm[0]
        g = g.permute(perm)
        transposed_shape = g.shape
        gm = g.reshape(g.shape[0], -1)
        pre_d = pre[dim_id] + gm @ gm.T
        if update_freq == 1 or count % update_freq == 0:
            inv_d = _inv_pth_root(pre_d, float(order))
        else:
            inv_d = inv[dim_id]
        if dim_id == order - 1:
            g = (gm.T @ inv_d).reshape(original_shape)
        else:
            g = (inv_d @ gm).reshape(transposed_shape)
        new_pre.append(pre_d)
        new_inv.append(inv_d)
    return -lr * g, g, tuple(new_pre), tuple(new_inv)


@OPTIMIZERS.register("Shampoo")
def shampoo(learning_rate, weight_decay=0.0, momentum=0.0, epsilon=1e-4,
            update_freq=1, **kw):
    lr = _f32(learning_rate)

    def init(params):
        def mats(k, p, fill):
            return tuple(fill(d, p) for d in to_flax(k, p).shape)

        eye = lambda d, p: epsilon * torch.eye(      # noqa: E731
            d, dtype=p.dtype, device=p.device)
        zero = lambda d, p: torch.zeros(             # noqa: E731
            (d, d), dtype=p.dtype, device=p.device)
        return {"count": 0, "buf": zeros_like(params),
                "preconds": LeafTree({k: mats(k, p, eye)
                                      for k, p in params.items()}),
                "inv_preconds": LeafTree({k: mats(k, p, zero)
                                          for k, p in params.items()})}

    def update(updates, state, params=None):
        first = state["count"] == 0
        out, buf, pre, inv = {}, {}, {}, {}
        for k, g in updates.items():
            p = None if params is None else to_flax(k, params[k].detach())
            o, b, pre[k], inv[k] = _shampoo_leaf(
                to_flax(k, g), p, to_flax(k, state["buf"][k]),
                state["preconds"][k], state["inv_preconds"][k], first,
                state["count"], lr, momentum, weight_decay, update_freq)
            out[k], buf[k] = from_flax(k, o), from_flax(k, b)
        return out, {"count": state["count"] + 1, "buf": ParamTree(buf),
                     "preconds": LeafTree(pre), "inv_preconds": LeafTree(inv)}

    return GradientTransformation(init, update)


# --------------------------------------------------------------------------
# Apollo
# --------------------------------------------------------------------------

@OPTIMIZERS.register("Apollo")
def apollo(learning_rate, weight_decay=0.0, beta=0.9, eps=1e-4,
           warmup=0, init_lr=0.01, **kw):
    """Apollo: the previous direction normalized by its 4-norm plus eps,
    the curvature rebound ``max(|B|, 1)``, the warmup on the step before
    the increment, coupled decay."""
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "B": zeros_like(params),
                "d": zeros_like(params)}

    def update(updates, state, params=None):
        k0 = state["count"]
        if warmup > 0 and k0 < warmup:
            f = np.float32
            lr_t = _f32((lr - f(init_lr)) * f(k0) / f(warmup) + f(init_lr))
        else:
            lr_t = _f32(lr)
        count = k0 + 1
        alpha = _f32(np.float32(1 - beta)
                     / np.float32(1 - np.float32(_pow(beta, count))))
        m, B, d, out = {}, {}, {}, {}
        for k, g in updates.items():
            if weight_decay and params is not None:
                g = g + weight_decay * params[k].detach()
            mo, Bo, do = state["m"][k], state["B"][k], state["d"][k]
            delta_grad = g - mo
            m[k] = mo + alpha * delta_grad
            d2 = do * do
            denom = torch.pow(torch.sum(d2 * d2), 0.25) + eps
            d_p = do / denom
            v_sq = d_p * d_p
            delta = (-alpha * torch.sum((delta_grad / denom) * d_p)
                     - torch.sum(Bo * v_sq))
            B[k] = Bo + v_sq * delta
            d[k] = m[k] / torch.clamp(torch.abs(B[k]), min=1.0)
            out[k] = -lr_t * d[k]
        return out, {"count": count, "m": ParamTree(m), "B": ParamTree(B),
                     "d": ParamTree(d)}

    return GradientTransformation(init, update)


# --------------------------------------------------------------------------
# A2GradUni
# --------------------------------------------------------------------------

@OPTIMIZERS.register("A2GradUni")
def a2grad_uni(learning_rate, weight_decay=0.0, beta=10.0, lips=10.0, **kw):
    """A2Grad, uniform averaging: the rate comes from ``gamma_k`` and
    ``h_k`` (``lr`` is not used), ``v_k`` is a per-leaf scalar running
    sum of squared deviations from the mean gradient, the auxiliary
    iterate is seeded from the initial parameters."""
    f = np.float32

    def init(params):
        return {"count": 0, "avg_grad": zeros_like(params),
                "v": LeafTree({k: torch.zeros((), dtype=p.dtype,
                                              device=p.device)
                               for k, p in params.items()}),
                "x": ParamTree({k: p.detach().clone()
                                for k, p in params.items()})}

    def update(updates, state, params):
        k0 = state["count"]
        kf = f(k0)
        gamma_k = _f32(f(2.0 * lips) / (kf + f(1)))
        alpha_prev = 1.0 if k0 == 0 else _f32(f(2) / (kf + f(2)))
        alpha_next = f(2) / (kf + f(3))
        one_minus = _f32(f(1) - alpha_next)
        mix = _f32(f(one_minus) * f(alpha_prev))
        avg, v, x, out = {}, {}, {}, {}
        for k, g in updates.items():
            p = params[k].detach()
            avg[k] = (state["avg_grad"][k] * _f32(kf) + g) / _f32(kf + f(1))
            delta = g - avg[k]
            v[k] = state["v"][k] + torch.sum(delta * delta)
            coef = 1.0 / (gamma_k + beta * torch.sqrt(v[k]))
            x[k] = state["x"][k] - coef * g
            p_new = (one_minus * p + _f32(alpha_next) * x[k]
                     - (mix * coef) * g)
            out[k] = p_new - p
        return out, {"count": k0 + 1, "avg_grad": ParamTree(avg),
                     "v": LeafTree(v), "x": ParamTree(x)}

    return GradientTransformation(init, update)
