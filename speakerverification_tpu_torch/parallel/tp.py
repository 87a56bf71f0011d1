"""Data × model parallel training with the class-sharded head (port of
``parallel/tp.py``).

A 2-D mesh ``(data, model)`` of ranks (``parallel.make_mesh``): the batch
is split over ``data`` as in ``parallel/dp.py``; the head's ``weight``
and its optimizer moments are split row-wise over ``model``
(``losses/sharded.py::ShardedAAmSoftmax``), the backbone is replicated.
Collectives: the gradient, metric and BatchNorm mean over the data
group, and the head's all-reduces over the model group, whose backward
sums the gradients of the model group's ranks, which the step undoes
with ``grad_scale = 1 / n_model``: every replicated parameter then gets
the same gradient on every model rank, and each row block the
gradient of its rows.

State leaves are named by path: ``params/<name>``,
``batch_stats/<name>``, ``opt_state/<key>/.../<name>`` (dict keys, tuple
indices, then the parameter's name in a ``ParamTree`` or ``LeafTree``).
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch
import torch.distributed as dist
import torch.nn as nn

from speakerverification_tpu_torch.optim import LeafTree, ParamTree
from speakerverification_tpu_torch.parallel.collectives import (
    bind,
    fold_in,
    gather_rows,
)
from speakerverification_tpu_torch.training.state import model_state

__all__ = ["tp_state_specs", "shard_state_tp", "make_dp_tp_train_step",
           "state_leaves", "map_leaves", "full_leaves"]

def _walk(node, path: str) -> Iterator[tuple[str, torch.Tensor]]:
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{path}/{k}")
    elif isinstance(node, tuple):
        for i, v in enumerate(node):
            yield from _walk(v, f"{path}/{i}")
    elif isinstance(node, torch.Tensor):
        yield path, node


def state_leaves(state) -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor of the state."""
    for key, t in state.params.items():
        yield f"params/{key}", t
    for key, t in state.batch_stats.items():
        yield f"batch_stats/{key}", t
    yield from _walk(state.opt_state, "opt_state")


def map_leaves(node, fn: Callable, path: str = "opt_state"):
    """``node`` (an optimizer state) with each tensor ``t`` at ``path``
    replaced by ``fn(path, t)``; containers keep their types."""
    if isinstance(node, dict):
        out = {k: map_leaves(v, fn, f"{path}/{k}") for k, v in node.items()}
        return type(node)(out) if isinstance(node, (ParamTree, LeafTree)) \
            else out
    if isinstance(node, tuple):
        return tuple(map_leaves(v, fn, f"{path}/{i}")
                     for i, v in enumerate(node))
    if isinstance(node, torch.Tensor):
        return fn(path, node)
    return node


def tp_state_specs(state, model_axis: str = "model",
                   n_model: int = 1) -> dict:
    """``{leaf path: (model_axis, None) or None}``: the head's 2-D
    ``weight`` (a name with a ``loss`` scope ending in ``weight``) and
    the optimizer leaves shaped and named like it row-sharded over
    ``model_axis``, where its rows divide by ``n_model``; every other leaf
    replicated (None)."""
    def spec(path: str, t: torch.Tensor):
        parts = path.rsplit("/", 1)[-1].split(".")
        if (t.dim() == 2 and parts[-1] == "weight" and "loss" in parts
                and t.shape[0] % max(n_model, 1) == 0):
            return (model_axis, None)
        return None
    return {path: spec(path, t) for path, t in state_leaves(state)}


def shard_state_tp(state, mesh, model_axis: str = "model"):
    """Keep this rank's row block of every leaf that
    :func:`tp_state_specs` shards (every rank holds the same full state,
    from the same seed): the head's ``weight`` becomes a parameter of
    ``rows / n_model`` rows, its optimizer moments likewise, and
    ``state.shards`` records the blocks. Returns ``state``."""
    group = mesh.get_group(model_axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    specs = tp_state_specs(state, model_axis, n)
    blocks = {}
    for path, t in state_leaves(state):
        if specs[path] is not None:
            rows = t.shape[0] // n
            blocks[path] = (r * rows, (r + 1) * rows, t.shape[0], group)
    for path, (lo, hi, _, _) in blocks.items():
        if not path.startswith("params/"):
            continue
        prefix, _, name = path[len("params/"):].rpartition(".")
        mod = state.model.get_submodule(prefix)
        old = getattr(mod, name)
        setattr(mod, name, nn.Parameter(old.detach()[lo:hi].clone(),
                                        requires_grad=old.requires_grad))
    state.params, state.batch_stats = model_state(state.model)
    state.opt_state = map_leaves(
        state.opt_state,
        lambda p, t: t[blocks[p][0]:blocks[p][1]].clone() if p in blocks
        else t)
    state.shards = blocks
    return state


def full_leaves(state) -> dict:
    """``{path: full tensor}`` of the state's sharded leaves, the row
    blocks gathered over each leaf's group in rank order (a collective:
    every rank of the groups calls it)."""
    leaves = dict(state_leaves(state))
    return {path: gather_rows(leaves[path].detach(), group)
            for path, (_, _, _, group) in state.shards.items()}


def make_dp_tp_train_step(model, tx, mesh, state_template,
                          data_axis: str = "data", model_axis: str = "model",
                          compute_dtype=None, augment_fn=None,
                          accum_steps: int = 1) -> Callable:
    """Build the 2-D step ``step(state, wave, label, lr, rng=None, *aug)``
    on this rank's shard of the batch (``wave [B_local, nPerSpeaker, T]``;
    the ranks of one model group take the same shard).

    ``state_template`` (the state, sharded or not) names the sharded
    leaves. The model's head must be model-axis aware
    (``ShardedAAmSoftmax``) and its class count must divide by the model
    axis, else ``ValueError``, as in JAX. The generator is folded with
    the data index only: model ranks draw identically, or the replicated
    backbone would diverge."""
    n_model = mesh.size(mesh.mesh_dim_names.index(model_axis))
    loss_mod = getattr(model, "loss", None)
    if getattr(loss_mod, "model_axis", None) != model_axis:
        raise ValueError(
            "make_dp_tp_train_step requires a model-axis-aware loss head "
            f"(got {type(loss_mod).__name__} with model_axis="
            f"{getattr(loss_mod, 'model_axis', None)!r}, expected "
            f"{model_axis!r}); use ShardedAAmSoftmax or set model_parallel=1")
    sharded = state_template.shards or {
        p for p, s in tp_state_specs(state_template, model_axis,
                                     n_model).items() if s is not None}
    if not sharded:
        raise ValueError(
            f"no 2-D loss weight is sharded over '{model_axis}' "
            f"(nClasses must be divisible by model_parallel={n_model}); "
            "pad the class count or lower model_parallel")
    # the one-device step imports this package's collectives
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    dgroup = mesh.get_group(data_axis)
    mgroup = mesh.get_group(model_axis)
    data_rank = mesh.get_local_rank(data_axis)
    inner = make_train_step(model, tx, compute_dtype=compute_dtype,
                            accum_steps=accum_steps, augment_fn=augment_fn,
                            data_group=dgroup, grad_scale=1.0 / n_model)

    def step(state, wave, label, lr, rng=None, *aug_args):
        if rng is not None:
            rng = fold_in(rng, data_rank)
        with bind(**{data_axis: dgroup, model_axis: mgroup}):
            return inner(state, wave, label, lr, rng, *aug_args)

    return step
