"""The class-sharded ArcFace head (port of ``losses/sharded.py``).

With ``model_parallel > 1`` each rank of a model group holds
``nClasses / n_model`` rows of the head's ``weight`` (rows
``[r·C_local, (r+1)·C_local)`` on the group's rank r;
``parallel.tp.shard_state_tp`` cuts them) and computes its block of
cosines ``[B, C_local]``:

* the embedding enters through :func:`~speakerverification_tpu_torch.
  parallel.collectives.copy_to_group` (identity forward, all-reduce-sum
  backward), as each rank's backward holds only its block's part of
  ``∂L/∂x``;
* the ArcFace margin is applied by the rank that owns the target class;
* the forward reduces over the group three times: an all-reduce max of
  the detached row maxima (the logsumexp shift, which carries no
  gradient), an all-reduce sum of the exponentials and an all-reduce sum
  of the target logit, the last two differentiable;
* top-1 takes the lowest global index among the classes at the global
  maximum, as the unsharded heads' argmax does (an all-reduce min).

Every rank then holds the same global loss; the differentiable
all-reduces sum each rank's gradient over the group, so the step scales
the gradients by ``1 / n_model`` (``grad_scale``), as the JAX step
undoes ``psum``'s transpose.

The group is the one a step binds to ``model_axis``
(``parallel.collectives.bind``). A head whose weight has all
``nClasses`` rows is the plain full-class ``AAmSoftmax`` computation
(init, a single process, evaluation).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from speakerverification_tpu_torch.losses.common import (
    flatten_grouped,
    l2_normalize,
    promoted_matmul,
)
from speakerverification_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    bound_group,
    copy_to_group,
)
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["ShardedAAmSoftmax"]


@LOSSES.register("ShardedAAmSoftmax")
class ShardedAAmSoftmax(nn.Module):
    """ArcFace ``s·cos(θ+m)`` with the class dimension sharded over the
    ranks bound to ``model_axis`` (the math of ``margin.AAmSoftmax``)."""
    test_normalize = True
    xavier_normal_params = ("weight",)

    def __init__(self, nOut: int = 192, nClasses: int = 5994,
                 margin: float = 0.2, scale: float = 30.0,
                 easy_margin: bool = False, model_axis: str = "model"):
        super().__init__()
        self.nClasses, self.margin, self.scale = nClasses, margin, scale
        self.easy_margin = easy_margin
        self.model_axis = model_axis
        self.weight = nn.Parameter(torch.empty(nClasses, nOut))
        nn.init.xavier_normal_(self.weight)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        x, label = flatten_grouped(x, label)
        w = self.weight
        c_local = w.shape[0]
        group = None
        if c_local != self.nClasses:
            group = bound_group(self.model_axis)
            if group is None:
                raise RuntimeError(
                    f"the head holds {c_local} of {self.nClasses} classes "
                    f"but no process group is bound to {self.model_axis!r} "
                    "(run it inside parallel.make_dp_tp_train_step)")
            x = copy_to_group(x, group)

        cosine = promoted_matmul(l2_normalize(x, -1),
                                 l2_normalize(w, -1).T)      # [B, C_local]
        cos_m, sin_m = math.cos(self.margin), math.sin(self.margin)
        th = math.cos(math.pi - self.margin)
        mm = math.sin(math.pi - self.margin) * self.margin
        sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
        phi = cosine * cos_m - sine * sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine - th > 0, phi, cosine - mm)

        offset = dist.get_rank(group) * c_local if group is not None else 0
        tgt_local = label.long() - offset
        valid = (tgt_local >= 0) & (tgt_local < c_local)
        one_hot = (F.one_hot(tgt_local.clamp(0, c_local - 1), c_local)
                   .to(cosine.dtype) * valid[:, None].to(cosine.dtype))
        logits = self.scale * (one_hot * phi + (1.0 - one_hot) * cosine)

        local_max = logits.max(dim=-1).values
        local_tgt = (one_hot * logits).sum(-1)
        if group is not None:
            gmax = local_max.detach().clone()
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
            z = all_reduce_sum(
                torch.exp(logits - gmax[:, None]).sum(-1), group)
            tgt_logit = all_reduce_sum(local_tgt, group)
        else:
            gmax = local_max
            z = torch.exp(logits - gmax[:, None]).sum(-1)
            tgt_logit = local_tgt
        loss = (-(tgt_logit - gmax - torch.log(z))).mean()

        # top-1 with the unsharded heads' tie-break (argmax: the lowest
        # class index): across ranks, the lowest global index among those
        # at the global maximum
        local_arg = logits.argmax(dim=-1) + offset
        if group is not None:
            g_arg = torch.where(local_max.detach() == gmax, local_arg,
                                torch.full_like(local_arg, self.nClasses))
            dist.all_reduce(g_arg, op=dist.ReduceOp.MIN, group=group)
        else:
            g_arg = local_arg
        prec1 = 100.0 * (g_arg == label.long()).float().mean()
        return loss, prec1
