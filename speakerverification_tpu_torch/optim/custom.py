"""The optimizer zoo (port of ``optim/custom.py``), each registered by its
YAML name, with the JAX package's semantics and state layout: a state is
a dict whose keys are the fields of JAX's ``*State`` NamedTuple, in
their order (chained ones are tuples, as optax's ``chain``).

* SGDW, QHM, QHAdam, DiffGrad, MADGRAD, AdaBound, AdaMod, AggMo, PID,
  AccSGD, RAdam: elementwise, over ``torch._foreach_*`` lists;
* AdamP and SGDP: the projection for scale-invariant weights, over the
  channel view of each leaf in flax layout (every axis but flax's last,
  the output channels) and then the layer view;
* SWATS: Adam until the projected step's scale converges, then SGD; a
  switch that one leaf triggers puts every later leaf (JAX's flatten
  order) on SGD in the same step; its flags stay on the device;
* AdaBelief, RAdam, Lamb, LARS, NovoGrad, Adafactor: the reference's
  semantics (decay coupling, debiasing, state seeding) as the JAX
  package ports them; Adafactor factors over the last two flax axes.

Scalars that JAX computes from the injected learning rate or the step
count are computed here in fp32 on the host (``_f32``, ``_pow``);
data-dependent ones stay 0-d tensors on the parameters' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from speakerverification_tpu_torch.optim import (
    GradientTransformation,
    LeafTree,
    ParamTree,
    _f32,
    _l2,
    _pow,
    add_decayed_weights,
    chain,
    flax_order,
    from_flax,
    identity,
    scale,
    to_flax,
    trace,
    zeros_like,
)
from speakerverification_tpu_torch.registry import OPTIMIZERS

__all__ = ["adabelief"]

def _lists(keys, *trees):
    return [[t[k] for k in keys] for t in trees]


def _lin(x, a, y, b):
    """``a·x + b·y`` over lists (``a``, ``b`` scalars)."""
    return torch._foreach_add(torch._foreach_mul(x, a),
                              torch._foreach_mul(y, b))


def _ema(old, new, decay):
    """``decay·old + (1 − decay)·new``."""
    return _lin(old, decay, new, 1 - decay)


def _ema_sq(old, g, decay):
    """``decay·old + ((1 − decay)·g)·g``, JAX's ``b2 * v + (1 - b2) * g
    * g``."""
    return torch._foreach_add(torch._foreach_mul(old, decay),
                              torch._foreach_mul(torch._foreach_mul(
                                  g, 1 - decay), g))


def _coupled(g, params, keys, weight_decay):
    """``g + wd·p`` (the coupled decay), where ``weight_decay`` is set and
    the params are given."""
    if weight_decay and params is not None:
        return torch._foreach_add(g, torch._foreach_mul(
            [params[k].detach() for k in keys], weight_decay))
    return g


def _bc(b, count):
    """``1 − b**count`` in fp32."""
    return _f32(1 - np.float32(_pow(b, count)))


def _zeros0(params):
    """A 0-d zero per leaf (a per-leaf scalar state)."""
    return LeafTree({k: torch.zeros((), dtype=p.dtype, device=p.device)
                     for k, p in params.items()})


def _clone(params):
    return ParamTree({k: p.detach().clone() for k, p in params.items()})


# --------------------------------------------------------------------------
# SGDW, QHM, QHAdam, DiffGrad
# --------------------------------------------------------------------------

@OPTIMIZERS.register("SGDW")
def sgdw(learning_rate, weight_decay=0.0, momentum=0.9, nesterov=False, **kw):
    """Momentum, then the decoupled decay, then the step."""
    return chain(trace(momentum, nesterov) if momentum else identity(),
                 add_decayed_weights(weight_decay),
                 scale(-_f32(learning_rate)))


def scale_by_qhm(nu: float = 0.7, beta: float = 0.999):
    def init(params):
        return {"momentum": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g, mo = _lists(keys, updates, state["momentum"])
        m = _ema(mo, g, beta)
        return dict(zip(keys, _lin(g, 1 - nu, m, nu))), {
            "momentum": ParamTree(zip(keys, m))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("QHM")
def qhm(learning_rate, weight_decay=0.0, nu=0.7, momentum=0.0, beta=None,
        **kw):
    """Quasi-hyperbolic momentum; ``beta`` is an older name of
    ``momentum``."""
    if beta is not None:
        momentum = beta
    return chain(_l2(weight_decay), scale_by_qhm(nu, momentum),
                 scale(-_f32(learning_rate)))


def scale_by_qhadam(nu1=0.7, nu2=1.0, b1=0.995, b2=0.999, eps=1e-8):
    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params=None):
        count = state["count"] + 1
        keys = list(updates)
        g, mo, vo = _lists(keys, updates, state["m"], state["v"])
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        mc = torch._foreach_div(m, _bc(b1, count))
        vc = torch._foreach_div(v, _bc(b2, count))
        num = _lin(g, 1 - nu1, mc, nu1)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, 1 - nu2), g),
            torch._foreach_mul(vc, nu2))), eps)
        return dict(zip(keys, torch._foreach_div(num, den))), {
            "count": count, "m": ParamTree(zip(keys, m)),
            "v": ParamTree(zip(keys, v))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("QHAdam")
def qhadam(learning_rate, weight_decay=0.0, nu1=1.0, nu2=1.0,
           b1=0.9, b2=0.999, eps=1e-8, **kw):
    return chain(_l2(weight_decay), scale_by_qhadam(nu1, nu2, b1, b2, eps),
                 scale(-_f32(learning_rate)))


def scale_by_diffgrad(b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params),
                "prev_grad": zeros_like(params)}

    def update(updates, state, params=None):
        count = state["count"] + 1
        keys = list(updates)
        g, mo, vo, pg = _lists(keys, updates, state["m"], state["v"],
                               state["prev_grad"])
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        friction = torch._foreach_sigmoid(torch._foreach_abs(
            torch._foreach_sub(pg, g)))
        out = torch._foreach_div(
            torch._foreach_mul(friction,
                               torch._foreach_div(m, _bc(b1, count))),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(v, _bc(b2, count))), eps))
        return dict(zip(keys, out)), {
            "count": count, "m": ParamTree(zip(keys, m)),
            "v": ParamTree(zip(keys, v)),
            "prev_grad": ParamTree(zip(keys, g))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("DiffGrad")
def diffgrad(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
             **kw):
    return chain(_l2(weight_decay), scale_by_diffgrad(b1, b2, eps),
                 scale(-_f32(learning_rate)))


# --------------------------------------------------------------------------
# MADGRAD, AdaBound, AdaMod
# --------------------------------------------------------------------------

@OPTIMIZERS.register("MADGRAD")
def madgrad(learning_rate, weight_decay=0.0, momentum=0.9, eps=1e-6, **kw):
    """MADGRAD as a whole update: the rate is ``lr + eps``, ``λ_k = (lr +
    eps)·√k``, the iterate an EMA of z with weight ``1 − momentum``."""
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "grad_sum": zeros_like(params),
                "grad_sum_sq": zeros_like(params), "x0": _clone(params)}

    def update(updates, state, params):
        keys = list(updates)
        g, s0, n0, x0 = _lists(keys, updates, state["grad_sum"],
                               state["grad_sum_sq"], state["x0"])
        p = [params[k].detach() for k in keys]
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        count = state["count"] + 1
        lamb = _f32((lr + np.float32(eps)) * np.sqrt(np.float32(count)))
        s = torch._foreach_add(s0, torch._foreach_mul(g, lamb))
        nu = torch._foreach_add(n0, torch._foreach_mul(
            torch._foreach_mul(g, lamb), g))

        def step(num, den):          # num / (cbrt(den) + eps)
            return torch._foreach_div(num, torch._foreach_add(
                torch._foreach_pow(den, 1.0 / 3.0), eps))

        if momentum == 0:
            xs = torch._foreach_add(p, step(s0, n0))
            new_p = torch._foreach_sub(xs, step(s, nu))
        else:
            z = torch._foreach_sub(x0, step(s, nu))
            new_p = _lin(p, momentum, z, 1 - momentum)
        return dict(zip(keys, torch._foreach_sub(new_p, p))), {
            "count": count, "grad_sum": ParamTree(zip(keys, s)),
            "grad_sum_sq": ParamTree(zip(keys, nu)), "x0": state["x0"]}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("AdaBound")
def adabound(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
             final_lr=0.1, gamma=1e-3, **kw):
    """Adam with its per-element rate clipped to bounds that close on
    ``final_lr``; the update carries its sign."""
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g, mo, vo = _lists(keys, updates, state["m"], state["v"])
        g = _coupled(g, params, keys, weight_decay)
        count = state["count"] + 1
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        step = _f32(lr * np.sqrt(np.float32(_bc(b2, count)))
                    / np.float32(_bc(b1, count)))
        t = np.float32(count)
        gt = np.float32(gamma) * t
        f = np.float32(final_lr)
        lower = _f32(f * (np.float32(1) - np.float32(1) / (gt + 1)))
        upper = _f32(f * (np.float32(1) + np.float32(1) / gt))
        out = []
        for mm, vv in zip(m, v):
            lr_t = torch.clamp(step / (torch.sqrt(vv) + eps), lower, upper)
            out.append(-lr_t * mm)
        return dict(zip(keys, out)), {"count": count,
                                      "m": ParamTree(zip(keys, m)),
                                      "v": ParamTree(zip(keys, v))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("AdaMod")
def adamod(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, b3=0.999,
           eps=1e-8, **kw):
    """Adam whose per-element rates are capped by their own EMA; the
    decay is decoupled (``− wd·lr·p``)."""
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params),
                "s": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g, mo, vo, so = _lists(keys, updates, state["m"], state["v"],
                               state["s"])
        count = state["count"] + 1
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        step = _f32(lr * np.sqrt(np.float32(_bc(b2, count)))
                    / np.float32(_bc(b1, count)))
        eta = [step / (torch.sqrt(vv) + eps) for vv in v]
        s = _ema(so, eta, b3)
        eta = torch._foreach_minimum(eta, s)
        out = torch._foreach_mul(torch._foreach_mul(eta, m), -1.0)
        if weight_decay and params is not None:
            out = torch._foreach_sub(out, torch._foreach_mul(
                [params[k].detach() for k in keys],
                _f32(np.float32(weight_decay) * lr)))
        return dict(zip(keys, out)), {
            "count": count, "m": ParamTree(zip(keys, m)),
            "v": ParamTree(zip(keys, v)), "s": ParamTree(zip(keys, s))}

    return GradientTransformation(init, update)


# --------------------------------------------------------------------------
# AdamP / SGDP
# --------------------------------------------------------------------------

def _adamp_projection(p, grad, perturb, delta, wd_ratio, eps):
    """The tangent-space projection of ``perturb`` (all in flax layout):
    the channel view (every axis but the last) where its largest
    |cos(grad, p)| is below ``delta / sqrt(fan_in)``, else the layer view
    where its |cos| is below ``delta / sqrt(size)``, else none. Returns
    ``(perturb', wd_ratio')`` (a 0-d tensor)."""
    ch_axes = tuple(range(p.dim() - 1))
    ly_axes = tuple(range(p.dim()))
    fan_in = math.prod(p.shape[:-1])

    def view_stats(axes, ncols):
        dot = torch.sum(grad * p, dim=axes)
        gn = torch.sqrt(torch.sum(grad * grad, dim=axes)) + eps
        pn = torch.sqrt(torch.sum(p * p, dim=axes)) + eps
        return torch.max(torch.abs(dot) / gn / pn) < delta / (ncols ** 0.5)

    def project(axes):
        pv_norm = torch.sqrt(torch.sum(p * p, dim=axes, keepdim=True)) + eps
        p_n = p / pv_norm
        inner = torch.sum(p_n * perturb, dim=axes, keepdim=True)
        return perturb - p_n * inner

    cond_ch = view_stats(ch_axes, fan_in)
    cond_ly = view_stats(ly_axes, p.numel())
    out = torch.where(cond_ch, project(ch_axes),
                      torch.where(cond_ly, project(ly_axes), perturb))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    wd = torch.where(cond_ch | cond_ly, one * wd_ratio, one)
    return out, wd


@OPTIMIZERS.register("AdamP")
def adamp(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
          delta=0.1, wd_ratio=0.1, nesterov=False, **kw):
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params):
        keys = list(updates)
        g, mo, vo = _lists(keys, updates, state["m"], state["v"])
        count = state["count"] + 1
        bc1, bc2 = _bc(b1, count), _bc(b2, count)
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        step_size = _f32(lr / np.float32(bc1))
        sq_bc2 = _f32(np.sqrt(np.float32(bc2)))
        out = []
        for k, gg, mm, vv in zip(keys, g, m, v):
            p = params[k].detach()
            denom = torch.sqrt(vv) / sq_bc2 + eps
            perturb = ((b1 * mm + (1 - b1) * gg) / denom if nesterov
                       else mm / denom)
            wdr = 1.0
            if p.dim() > 1:
                pf, wdr = _adamp_projection(
                    to_flax(k, p), to_flax(k, gg), to_flax(k, perturb),
                    delta, wd_ratio, eps)
                perturb = from_flax(k, pf)
            u = -step_size * perturb
            if weight_decay > 0:
                u = (_f32(-lr * np.float32(weight_decay)) * wdr) * p - \
                    step_size * perturb
            out.append(u)
        return dict(zip(keys, out)), {"count": count,
                                      "m": ParamTree(zip(keys, m)),
                                      "v": ParamTree(zip(keys, v))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("SGDP")
def sgdp(learning_rate, weight_decay=0.0, momentum=0.9, dampening=0.0,
         eps=1e-8, delta=0.1, wd_ratio=0.1, nesterov=False, **kw):
    lr = np.float32(learning_rate)

    def init(params):
        return {"momentum": zeros_like(params)}

    def update(updates, state, params):
        keys = list(updates)
        g, bo = _lists(keys, updates, state["momentum"])
        buf = _lin(bo, momentum, g, 1 - dampening)
        out = []
        for k, gg, b in zip(keys, g, buf):
            p = params[k].detach()
            d_p = gg + momentum * b if nesterov else b
            wdr = 1.0
            if p.dim() > 1:
                df, wdr = _adamp_projection(
                    to_flax(k, p), to_flax(k, gg), to_flax(k, d_p), delta,
                    wd_ratio, eps)
                d_p = from_flax(k, df)
            u = -(_f32(lr) * d_p)
            if weight_decay != 0:
                u = ((_f32(-lr * np.float32(weight_decay)) * wdr)
                     / (1 - momentum)) * p - _f32(lr) * d_p
            out.append(u)
        return dict(zip(keys, out)), {"momentum": ParamTree(zip(keys, buf))}

    return GradientTransformation(init, update)


# --------------------------------------------------------------------------
# AggMo, PID, AccSGD, SWATS
# --------------------------------------------------------------------------

@OPTIMIZERS.register("AggMo")
def aggmo(learning_rate, weight_decay=0.0, betas=(0.0, 0.9, 0.99), **kw):
    betas = tuple(betas)
    lr = _f32(learning_rate)

    def init(params):
        return {"traces": tuple(zeros_like(params) for _ in betas)}

    def update(updates, state, params=None):
        keys = list(updates)
        g = _coupled([updates[k] for k in keys], params, keys, weight_decay)
        traces = [torch._foreach_add(torch._foreach_mul(
            [tr[k] for k in keys], b), g)
            for b, tr in zip(betas, state["traces"])]
        total = traces[0]
        for tr in traces[1:]:
            total = torch._foreach_add(total, tr)
        avg = torch._foreach_div(total, len(betas))
        return dict(zip(keys, torch._foreach_mul(avg, -lr))), {
            "traces": tuple(ParamTree(zip(keys, tr)) for tr in traces)}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("PID")
def pid(learning_rate, weight_decay=0.0, momentum=0.0, dampening=0.0,
        integral=5.0, derivative=10.0, **kw):
    """PID-controller SGD: plain SGD at ``momentum`` 0 (the buffers stay);
    on the first momentum step the D term is zero and the stored
    previous gradient stays zero."""
    lr = _f32(learning_rate)

    def init(params):
        return {"count": 0, "prev_grad": zeros_like(params),
                "i_buf": zeros_like(params), "d_buf": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g = _coupled([updates[k] for k in keys], params, keys, weight_decay)
        if momentum == 0:
            return dict(zip(keys, torch._foreach_mul(g, -lr))), state
        count = state["count"] + 1
        i0, d0, pg = _lists(keys, state["i_buf"], state["d_buf"],
                            state["prev_grad"])
        if count == 1:
            i_buf = torch._foreach_add(torch._foreach_mul(i0, momentum), g)
            d_buf = [torch.zeros_like(x) for x in g]
            prev = [torch.zeros_like(x) for x in g]
        else:
            i_buf = _lin(i0, momentum, g, 1 - dampening)
            d_buf = _lin(d0, momentum, torch._foreach_sub(g, pg), 1 - momentum)
            prev = g
        total = torch._foreach_add(torch._foreach_add(
            g, torch._foreach_mul(i_buf, integral)),
            torch._foreach_mul(d_buf, derivative))
        return dict(zip(keys, torch._foreach_mul(total, -lr))), {
            "count": count, "prev_grad": ParamTree(zip(keys, prev)),
            "i_buf": ParamTree(zip(keys, i_buf)),
            "d_buf": ParamTree(zip(keys, d_buf))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("AccSGD")
def accsgd(learning_rate, weight_decay=0.0, kappa=1000.0, xi=10.0,
           small_const=0.7, **kw):
    """Accelerated SGD: an auxiliary iterate seeded from the initial
    parameters, coupled decay."""
    lr = np.float32(learning_rate)
    large_lr = _f32(lr * np.float32(kappa) / np.float32(small_const))
    alpha = 1.0 - (small_const * small_const * xi) / kappa
    beta = 1.0 - alpha
    zeta = small_const / (small_const + beta)

    def init(params):
        return {"buf": _clone(params)}

    def update(updates, state, params):
        keys = list(updates)
        p = [params[k].detach() for k in keys]
        g = _coupled([updates[k] for k in keys], params, keys, weight_decay)
        b0 = [state["buf"][k] for k in keys]
        buf = torch._foreach_mul(torch._foreach_add(torch._foreach_sub(
            torch._foreach_mul(b0, 1.0 / beta - 1.0),
            torch._foreach_mul(g, large_lr)), p), beta)
        new_p = _lin(torch._foreach_sub(p, torch._foreach_mul(g, _f32(lr))),
                     zeta, buf, 1.0 - zeta)
        return dict(zip(keys, torch._foreach_sub(new_p, p))), {
            "buf": ParamTree(zip(keys, buf))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("SWATS")
def swats(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-3,
          nesterov=False, **kw):
    """Adam until the projected step's scaling EMA converges, then SGD at
    the learned rate. The leaves go in JAX's flatten order: a switch that
    one triggers puts every later leaf on SGD in the same step, its
    momentum seeded from the current gradient. The phase, the SGD rate,
    the per-leaf EMAs and flags are tensors on the device."""
    lr = np.float32(learning_rate)

    def init(params):
        dev = next(iter(params.values())).device
        return {"count": 0,
                "phase_sgd": torch.zeros((), dtype=torch.bool, device=dev),
                "lr_sgd": torch.tensor(_f32(lr), dtype=torch.float32,
                                       device=dev),
                "m": zeros_like(params), "v": zeros_like(params),
                "exp_avg2": _zeros0(params), "buf": zeros_like(params),
                "buf_started": LeafTree({
                    k: torch.zeros((), dtype=torch.bool, device=p.device)
                    for k, p in params.items()})}

    def update(updates, state, params=None):
        count = state["count"] + 1
        bc1, bc2 = _bc(b1, count), _bc(b2, count)
        step_size = _f32(lr * np.float32(bc2) ** np.float32(0.5)
                         / np.float32(bc1))
        phase, lr_sgd = state["phase_sgd"], state["lr_sgd"]
        out, nm, nv, ne2, nbuf, nst = ({} for _ in range(6))
        for k in flax_order(updates):
            g = updates[k]
            if weight_decay != 0 and params is not None:
                g = g + weight_decay * params[k].detach()
            m, v, e2 = state["m"][k], state["v"][k], state["exp_avg2"][k]
            bf, st = state["buf"][k], state["buf_started"][k]
            m1 = b1 * m + (1 - b1) * g
            v1 = b2 * v + (1 - b2) * g * g
            adam_upd = -step_size * (m1 / (torch.sqrt(v1) + eps))
            pg = torch.sum(adam_upd * g)
            zero = pg == 0
            scaling = torch.sum(adam_upd * adam_upd) / -torch.where(
                zero, torch.ones_like(pg), pg)
            e2_new = torch.where(zero, e2, b2 * e2 + (1 - b2) * scaling)
            corrected = e2_new / bc2
            trigger = (~zero & (torch.abs(corrected - scaling)
                                <= 1e-8 + 1e-6 * torch.abs(scaling))
                       & (corrected > 0))
            if count == 1:
                trigger = torch.zeros_like(trigger)
            buf_new = torch.where(st, b1 * bf + g, g)
            d = buf_new * (1 - b1)
            if nesterov:
                d = d + b1 * buf_new
            out[k] = torch.where(phase, -lr_sgd * d, adam_upd)
            nm[k] = torch.where(phase, m, m1)
            nv[k] = torch.where(phase, v, v1)
            ne2[k] = torch.where(phase, e2, e2_new)
            nbuf[k] = torch.where(phase, buf_new, bf)
            nst[k] = st | phase
            new_phase = phase | trigger
            lr_sgd = torch.where(new_phase & ~phase, corrected, lr_sgd)
            phase = new_phase
        keys = list(updates)
        return {k: out[k] for k in keys}, {
            "count": count, "phase_sgd": phase, "lr_sgd": lr_sgd,
            "m": ParamTree((k, nm[k]) for k in keys),
            "v": ParamTree((k, nv[k]) for k in keys),
            "exp_avg2": LeafTree((k, ne2[k]) for k in keys),
            "buf": ParamTree((k, nbuf[k]) for k in keys),
            "buf_started": LeafTree((k, nst[k]) for k in keys)}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("AdaBelief")
def adabelief(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
              weight_decouple=False, fixed_decay=False, rectify=False, **kw):
    lr = _f32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params=None):
        count = state["count"] + 1
        bc1 = _f32(1 - np.float32(_pow(b1, count)))
        bc2 = _f32(1 - np.float32(_pow(b2, count)))
        keys = list(updates)
        g = [updates[k] for k in keys]
        p = None if params is None else [params[k].detach() for k in keys]
        if not weight_decouple and weight_decay != 0 and p is not None:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        m = torch._foreach_add(
            torch._foreach_mul([state["m"][k] for k in keys], b1),
            torch._foreach_mul(g, 1 - b1))
        r = torch._foreach_sub(g, m)
        v = torch._foreach_add(torch._foreach_add(
            torch._foreach_mul([state["v"][k] for k in keys], b2),
            torch._foreach_mul(torch._foreach_mul(r, r), 1 - b2)), eps)
        use_denom = True
        if rectify:
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho_t = _f32(rho_inf - np.float32(2 * count)
                         * np.float32(_pow(b2, count)) / np.float32(bc2))
            use_denom = rho_t > 4
            if use_denom:
                rt = _f32(math.sqrt(_f32(
                    (rho_t - 4.0) * (rho_t - 2.0) * rho_inf / (rho_inf - 4.0)
                    / (rho_inf - 2.0) / max(rho_t, 4.001))))
                step_size = _f32(np.float32(rt) * np.float32(lr)
                                 / np.float32(bc1))
            else:
                step_size = lr
        else:
            step_size = _f32(np.float32(lr) / np.float32(bc1))
        out = torch._foreach_mul(m, -step_size)
        if use_denom:
            denom = torch._foreach_add(torch._foreach_div(
                torch._foreach_sqrt(v), _f32(math.sqrt(bc2))), eps)
            out = torch._foreach_div(out, denom)
        if weight_decouple:
            factor = (1.0 - weight_decay if fixed_decay
                      else 1.0 - lr * weight_decay)
            if p is None:
                p = [torch.zeros_like(x) for x in m]
            out = torch._foreach_add(out, torch._foreach_mul(p, factor - 1.0))
        return dict(zip(keys, out)), {"count": count,
                                      "m": ParamTree(zip(keys, m)),
                                      "v": ParamTree(zip(keys, v))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("RAdam")
def radam(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, **kw):
    """Rectified Adam: the decoupled decay ``− wd·lr·p`` in the same step,
    ``eps`` after the square root, SGD-style steps while the SMA length
    is below 5."""
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        g, mo, vo = _lists(keys, updates, state["m"], state["v"])
        count = state["count"] + 1
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        f = np.float32
        bc1 = f(_bc(b1, count))
        beta2_t = f(_pow(b2, count))
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = f(n_sma_max) - f(2 * count) * beta2_t / (f(1) - beta2_t)
        rect = np.sqrt(max(
            (f(1) - beta2_t) * (n_sma - f(4)) / f(n_sma_max - 4)
            * (n_sma - f(2)) / max(n_sma, f(1e-12))
            * f(n_sma_max) / f(n_sma_max - 2), f(0)))
        if n_sma >= 5:
            step = _f32(lr * rect / bc1)
            out = torch._foreach_div(torch._foreach_mul(m, -step),
                                   torch._foreach_add(torch._foreach_sqrt(v),
                                                    eps))
        else:
            out = torch._foreach_mul(m, -_f32(lr / bc1))
        if weight_decay != 0 and params is not None:
            out = torch._foreach_sub(out, torch._foreach_mul(
                [params[k].detach() for k in keys],
                _f32(f(weight_decay) * lr)))
        return dict(zip(keys, out)), {"count": count,
                                      "m": ParamTree(zip(keys, m)),
                                      "v": ParamTree(zip(keys, v))}

    return GradientTransformation(init, update)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of all of ``x``, as ``jnp.linalg.norm``."""
    return torch.sqrt(torch.sum(x * x))


@OPTIMIZERS.register("Lamb")
def lamb(learning_rate, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-6,
         clamp_value=10.0, adam=False, debias=False, **kw):
    """LAMB: no debiasing by default, the decay added to the Adam step,
    the weight norm clamped to ``[0, clamp_value]``, the trust ratio 1
    where either norm is 0 (or with ``adam``)."""
    lr = np.float32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": zeros_like(params)}

    def update(updates, state, params):
        keys = list(updates)
        g, mo, vo = _lists(keys, updates, state["m"], state["v"])
        count = state["count"] + 1
        m, v = _ema(mo, g, b1), _ema_sq(vo, g, b2)
        step_size = (_f32(lr * np.sqrt(np.float32(_bc(b2, count)))
                          / np.float32(_bc(b1, count)))
                     if debias else _f32(lr))
        steps = torch._foreach_div(
            m, torch._foreach_add(torch._foreach_sqrt(v), eps))
        if weight_decay != 0:
            steps = torch._foreach_add(steps, torch._foreach_mul(
                [params[k].detach() for k in keys], weight_decay))
        out = []
        for k, a in zip(keys, steps):
            if adam:
                out.append(-step_size * a)
                continue
            w_norm = torch.clamp(_norm(params[k].detach()), 0, clamp_value)
            a_norm = _norm(a)
            one = torch.ones_like(a_norm)
            trust = torch.where((w_norm == 0) | (a_norm == 0), one,
                                w_norm / torch.where(a_norm == 0, one,
                                                     a_norm))
            out.append((-step_size * trust) * a)
        return dict(zip(keys, out)), {"count": count,
                                      "m": ParamTree(zip(keys, m)),
                                      "v": ParamTree(zip(keys, v))}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("LARS")
def lars(learning_rate, weight_decay=0.0, momentum=0.0, dampening=0.0,
         nesterov=False, trust_coefficient=0.01, eps=1e-8, **kw):
    """LARS: the trust-ratio scaling only with ``weight_decay`` set and
    both norms nonzero (else the raw gradient), the momentum buffer
    seeded from the first step's direction."""
    lr = _f32(learning_rate)

    def init(params):
        return {"count": 0, "buf": zeros_like(params)}

    def update(updates, state, params):
        keys = list(updates)
        first = state["count"] == 0
        d_p = []
        for k in keys:
            g = updates[k]
            if weight_decay == 0:
                d_p.append(g)
                continue
            p = params[k].detach()
            p_norm, g_norm = _norm(p), _norm(g)
            lars_lr = trust_coefficient * p_norm / (
                g_norm + p_norm * weight_decay + eps)
            d_p.append(torch.where((p_norm != 0) & (g_norm != 0),
                                   (g + weight_decay * p) * lars_lr, g))
        if momentum != 0:
            buf = (d_p if first else
                   _lin([state["buf"][k] for k in keys], momentum, d_p,
                        1 - dampening))
            d_p = (torch._foreach_add(d_p, torch._foreach_mul(buf, momentum))
                   if nesterov else buf)
            buf = ParamTree(zip(keys, buf))
        else:
            buf = state["buf"]
        return dict(zip(keys, torch._foreach_mul(d_p, -lr))), {
            "count": state["count"] + 1, "buf": buf}

    return GradientTransformation(init, update)


@OPTIMIZERS.register("NovoGrad")
def novograd(learning_rate, weight_decay=0.0, b1=0.95, b2=0.0, eps=1e-8,
             grad_averaging=False, **kw):
    """NovoGrad: a per-leaf scalar second moment of ``||g||²`` seeded from
    the first one, the decay added after the normalization, ``m = b1·m +
    g`` (times ``1 − b1`` with ``grad_averaging``)."""
    lr = _f32(learning_rate)

    def init(params):
        return {"count": 0, "m": zeros_like(params), "v": _zeros0(params)}

    def update(updates, state, params):
        m, v, out = {}, {}, {}
        for k in updates:
            g, mm, vv = updates[k], state["m"][k], state["v"][k]
            norm = torch.sum(g * g)
            v[k] = torch.where(vv == 0, norm, b2 * vv + (1 - b2) * norm)
            g = g / (torch.sqrt(v[k]) + eps)
            if weight_decay != 0:
                g = g + weight_decay * params[k].detach()
            if grad_averaging:
                g = g * (1 - b1)
            m[k] = b1 * mm + g
            out[k] = -lr * m[k]
        return out, {"count": state["count"] + 1, "m": ParamTree(m),
                     "v": LeafTree(v)}

    return GradientTransformation(init, update)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return _norm(x) / _f32(x.numel() ** 0.5)


@OPTIMIZERS.register("Adafactor")
def adafactor(learning_rate, weight_decay=0.0, eps2=(1e-30, 1e-3),
              clip_threshold=1.0, decay_rate=-0.8, beta1=None,
              scale_parameter=True, relative_step=True, warmup_init=False,
              **kw):
    """Adafactor (fairseq semantics): with ``relative_step`` the rate is
    ``min(1e-2, 1/√t)`` (the learning rate is not used), scaled by
    ``max(eps2[1], RMS(p))``; every leaf of rank ≥ 2 is factored over its
    last two flax axes (``vr`` rows, ``vc`` columns, in flax layout);
    the update is clipped by its RMS; the decay is ``wd·lr_t``,
    decoupled. The first moment is kept only with ``beta1``."""
    lr = np.float32(learning_rate)
    f = np.float32

    def init(params):
        def rows(k, p):
            pf = to_flax(k, p)
            return (torch.zeros(pf.shape[:-1], dtype=p.dtype,
                                device=p.device) if p.dim() >= 2
                    else torch.zeros_like(p))

        def cols(k, p):
            pf = to_flax(k, p)
            return (torch.zeros(pf.shape[:-2] + pf.shape[-1:],
                                dtype=p.dtype, device=p.device)
                    if p.dim() >= 2 else
                    torch.zeros((), dtype=p.dtype, device=p.device))

        return {"count": 0,
                "m": zeros_like(params) if beta1 is not None
                else _zeros0(params),
                "vr": LeafTree({k: rows(k, p) for k, p in params.items()}),
                "vc": LeafTree({k: cols(k, p) for k, p in params.items()})}

    def update(updates, state, params):
        count = state["count"] + 1
        tf = f(count)
        if relative_step:
            min_step = f(1e-6) * tf if warmup_init else f(1e-2)
            rel_step = _f32(min(min_step, f(1) / np.sqrt(tf)))
        else:
            rel_step = _f32(lr)
        beta2t = _f32(f(1) - tf ** f(decay_rate))
        m_out, vr_out, vc_out, out = {}, {}, {}, {}
        for k in updates:
            p = params[k].detach()
            g = to_flax(k, updates[k])
            pf = to_flax(k, p)
            vr, vc = state["vr"][k], state["vc"][k]
            lr_t = (rel_step * torch.clamp(_rms(pf), min=eps2[1])
                    if scale_parameter else rel_step)
            upd = g * g + eps2[0]
            if g.dim() >= 2:
                vr_new = beta2t * vr + (1 - beta2t) * upd.mean(dim=-1)
                vc_new = beta2t * vc + (1 - beta2t) * upd.mean(dim=-2)
                r_factor = torch.rsqrt(
                    vr_new / vr_new.mean(dim=-1, keepdim=True))[..., None]
                c_factor = torch.rsqrt(vc_new)[..., None, :]
                upd = r_factor * c_factor * g
            else:
                vr_new = beta2t * vr + (1 - beta2t) * upd
                vc_new = vc
                upd = torch.rsqrt(vr_new) * g
            upd = upd / torch.clamp(_rms(upd) / clip_threshold, min=1.0)
            upd = from_flax(k, upd * lr_t)
            if beta1 is not None:
                m_out[k] = beta1 * state["m"][k] + (1 - beta1) * upd
                upd = m_out[k]
            else:
                m_out[k] = state["m"][k]
            o = -upd
            if weight_decay != 0:
                o = o - (weight_decay * lr_t) * p
            out[k] = o
            vr_out[k], vc_out[k] = vr_new, vc_new
        m_tree = ParamTree(m_out) if beta1 is not None else LeafTree(m_out)
        return out, {"count": count, "m": m_tree, "vr": LeafTree(vr_out),
                     "vc": LeafTree(vc_out)}

    return GradientTransformation(init, update)
