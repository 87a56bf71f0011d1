"""Process-group collectives of the multi-GPU steps, and the axis names
a step binds.

The JAX package runs its steps inside ``shard_map``, where a collective
names a mesh axis (``'data'``, ``'model'``) that the program binds. The
port runs one process per GPU: :func:`bind` makes a
``torch.distributed`` process group the meaning of an axis name for the
duration of a step, and :func:`bound_group` looks it up (None outside
any step, where the modules take their one-device paths, as the JAX
modules do outside ``shard_map``).

The differentiable collectives follow JAX's transposes: the backward of
an all-reduce-sum is an all-reduce-sum (``psum``'s transpose), the
backward of an all-gather sums the gradients of every rank's copy and
keeps this rank's rows (``all_gather``'s transpose, a reduce-scatter,
written as an all-reduce so that gloo runs it too), and
:func:`copy_to_group` is the identity forward with an all-reduce-sum
backward (Megatron's copy-to-model-parallel-region).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["bind", "bound_group", "all_reduce_sum", "copy_to_group",
           "all_gather_rows", "gather_rows", "mean_over_group_", "broadcast_",
           "fold_in"]

_BOUND: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "svtorch_bound_axes", default={})


@contextlib.contextmanager
def bind(**groups) -> Iterator[None]:
    """Bind axis names to process groups (``bind(data=g)``) while the
    block runs; a None group leaves the name unbound."""
    token = _BOUND.set({**_BOUND.get(),
                        **{k: g for k, g in groups.items() if g is not None}})
    try:
        yield
    finally:
        _BOUND.reset(token)


def bound_group(axis: Optional[str]):
    """The process group bound to ``axis``, or None."""
    return None if axis is None else _BOUND.get().get(axis)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (no
    gradient). gloo gathers host tensors: a CUDA tensor is staged through
    the host."""
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(x.device) if staged else out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.rows
        return g[lo:lo + ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum``: the sum over the group, differentiable."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce-sum backward: ``x`` enters every rank
    of the group replicated, and each rank's backward holds only its own
    part of ``∂L/∂x``."""
    return _CopyToGroup.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order
    (``all_gather(..., tiled=True)``), differentiable."""
    return _AllGatherRows.apply(x, group)


def _coalesced(tensors: Sequence[torch.Tensor]):
    """The tensors grouped by (dtype, device), each group as one flat
    buffer: ``[(indices, flat)]``."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return [(idx, torch.cat([tensors[i].reshape(-1) for i in idx]))
            for idx in groups.values()]


def _scatter_back(tensors, idx, flat) -> None:
    off = 0
    for i in idx:
        n = tensors[i].numel()
        tensors[i].copy_(flat[off:off + n].view_as(tensors[i]))
        off += n


@torch.no_grad()
def mean_over_group_(tensors: Sequence[torch.Tensor], group) -> None:
    """``pmean`` in place: each tensor becomes its mean over the group's
    ranks (one all-reduce per dtype and device)."""
    n = dist.get_world_size(group)
    if n == 1 or not tensors:
        return
    for idx, flat in _coalesced(tensors):
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        _scatter_back(tensors, idx, flat)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Every tensor set to global rank ``src``'s value, in place."""
    if dist.get_world_size(group) == 1 or not tensors:
        return
    for idx, flat in _coalesced(tensors):
        dist.broadcast(flat, src=src, group=group)
        _scatter_back(tensors, idx, flat)


def fold_in(rng: torch.Generator, index: int) -> torch.Generator:
    """A generator on ``rng``'s device seeded from ``rng``'s state and
    ``index`` (``jax.random.fold_in``). ``rng`` is advanced by one draw,
    so the next call folds another state; ranks whose ``rng`` agree and
    whose ``index`` agrees draw identically."""
    state = rng.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(index).to_bytes(8, "little"),
                             digest_size=8).digest()
    out = torch.Generator(device=rng.device)
    out.manual_seed(int.from_bytes(digest, "little") >> 1)
    torch.empty(1, device=rng.device).uniform_(generator=rng)
    return out
