"""The train state (port of ``training/state.py``): step, params, batch
statistics and optimizer state.

``params`` and ``batch_stats`` are the model's own tensors by the
port's names (the trainable parameters; the BatchNorm running means and
variances), so a step that updates them in place updates the model.
``training/checkpoint.py`` writes the state in the JAX ``TrainState``'s
layout. ``shards`` names the leaves of which this rank holds a row
block (the class-sharded head and its optimizer moments,
``parallel.tp.shard_state_tp``): leaf path → ``(lo, hi, rows, group)``,
rows ``[lo, hi)`` of ``rows``, the others on the ranks of ``group``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from speakerverification_tpu_torch.weights import init_weights_

__all__ = ["TrainState", "create_train_state", "model_state"]

_STATS = ("running_mean", "running_var")


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    batch_stats: dict
    opt_state: Any
    model: nn.Module
    shards: dict = dataclasses.field(default_factory=dict)


def model_state(model: nn.Module) -> tuple[dict, dict]:
    """``(params, batch_stats)``: the model's trainable parameters and its
    BatchNorm running statistics, by name (the tensors themselves)."""
    params = {k: p for k, p in model.named_parameters()}
    stats = {k: b for k, b in model.named_buffers()
             if k.rpartition(".")[2] in _STATS}
    return params, stats


def create_train_state(model: nn.Module, tx, seed: int) -> TrainState:
    """Initialize ``model``'s weights from ``torch.Generator(seed)`` as
    flax initializes them (``weights.init_weights_``) and the optimizer
    state for its parameters."""
    init_weights_(model, torch.Generator().manual_seed(int(seed)))
    params, stats = model_state(model)
    return TrainState(step=0, params=params, batch_stats=stats,
                      opt_state=tx.init({k: p.detach()
                                         for k, p in params.items()}),
                      model=model)
