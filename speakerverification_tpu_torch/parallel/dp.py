"""Data-parallel training, one process per GPU (port of
``parallel/dp.py``).

The JAX step runs under ``shard_map`` over the data axis of a mesh and
``pmean``s gradients, loss, precision and BatchNorm statistics. Here
each rank runs the one-device step on its own shard of the batch with
the data axis's process group (``training/train_step.py``'s
``data_group``), which averages the same four over the ranks: every
rank applies the same update, as DDP keeps replicas equal. BatchNorm's
running statistics are averaged too (each shard normalizes with its own
batch statistics, as in JAX), which is why the port does not use
``DistributedDataParallel``: its ``broadcast_buffers`` would overwrite
every rank's statistics with rank 0's. Each data rank draws from the
step's generator folded with its data index, as the JAX step folds the
replica index into its key.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from speakerverification_tpu_torch.parallel.collectives import (
    bind,
    broadcast_,
    fold_in,
)
from speakerverification_tpu_torch.parallel.tp import state_leaves

__all__ = ["make_dp_train_step", "replicate_state", "shard_batch"]


def make_dp_train_step(model, tx, mesh, axis: str = "data",
                       compute_dtype=None, augment_fn=None,
                       accum_steps: int = 1) -> Callable:
    """Build ``step(state, wave, label, lr, rng=None, *aug_args)`` on this
    rank's shard (``wave [B_local, nPerSpeaker, T]``) with the mean over
    ``mesh``'s ``axis``. ``compute_dtype``, ``augment_fn`` and
    ``accum_steps`` are the one-device step's (each rank accumulates its
    own shard)."""
    # the one-device step imports this package's collectives
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    group = mesh.get_group(axis)
    data_rank = mesh.get_local_rank(axis)
    inner = make_train_step(model, tx, compute_dtype=compute_dtype,
                            accum_steps=accum_steps, augment_fn=augment_fn,
                            data_group=group)

    def step(state, wave, label, lr, rng=None, *aug_args):
        if rng is not None:
            rng = fold_in(rng, data_rank)
        with bind(**{axis: group}):
            return inner(state, wave, label, lr, rng, *aug_args)

    return step


def replicate_state(state, mesh=None):
    """Every rank's state set to rank 0's (weights, statistics, optimizer
    state; in place). Returns ``state``."""
    broadcast_([t for _, t in state_leaves(state)], src=0)
    return state


def shard_batch(batch, mesh, axis: str = "data", device=None):
    """This rank's contiguous rows of a global batch (a mapping of arrays
    or tensors, or one of them), as tensors on ``device``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"over {n} data ranks")
        rows = t.shape[0] // n
        t = t[r * rows:(r + 1) * rows]
        return t.to(device) if device is not None else t
    if isinstance(batch, Mapping):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)
