"""FLOPs of the reference model, counted once by ``FlopCounterMode`` on
the meta device (no arithmetic, no memory), at a small batch and scaled:
every counted operation (convolutions and matrix products, forward and
backward) is linear in the batch. FFTs are not counted, so a share of
the peak reads low, never high."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["forward_flops", "train_flops"]


def _meta_copy(model: torch.nn.Module) -> torch.nn.Module:
    import copy
    return copy.deepcopy(model).to("meta")


def forward_flops(model: torch.nn.Module, samples: int,
                  batch: int = 2) -> float:
    """FLOPs of one crop of ``samples`` through ``model.embed``."""
    m = _meta_copy(model).eval()
    x = torch.zeros(batch, samples, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        m.embed(x)
    return fc.get_total_flops() / batch


def train_flops(model: torch.nn.Module, samples: int, n_per: int,
                batch: int = 2) -> float:
    """FLOPs of one crop through ``model.loss_of`` and its backward with
    respect to the parameters."""
    m = _meta_copy(model).train()
    x = torch.zeros(batch, n_per, samples, device="meta")
    label = torch.zeros(batch, dtype=torch.long, device="meta")
    params = [p for p in m.parameters()]
    with FlopCounterMode(display=False) as fc:
        loss = m.loss_of(x, label)
        torch.autograd.grad(loss, params, allow_unused=True)
    return fc.get_total_flops() / (batch * n_per)
