"""AdaBelief (port of ``optim/custom.py::adabelief``), with the
reference's semantics: coupled decay by default, ``eps`` added into the
stored variance every step (``v = b2·v + (1−b2)(g−m)² + eps``), and the
optional decoupled decay and rectification of its constructor."""

from __future__ import annotations

import math

import numpy as np
import torch

from speakerverification_tpu_torch.optim import (
    GradientTransformation,
    ParamTree,
    _f32,
    _pow,
    zeros_like,
)
from speakerverification_tpu_torch.registry import OPTIMIZERS

__all__ = ["adabelief"]


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
