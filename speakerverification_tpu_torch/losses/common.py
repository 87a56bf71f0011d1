"""Shared helpers of the loss heads (port of ``losses/common.py``)."""

from __future__ import annotations

import torch

__all__ = ["l2_normalize", "cross_entropy", "top1_percent", "flatten_grouped",
           "promoted_matmul"]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels in the logits'
    dtype, as optax's ``softmax_cross_entropy_with_integer_labels``
    computes it: ``logsumexp(z) - z[label]``."""
    label_logits = logits.gather(-1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - label_logits).mean()


def top1_percent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent (fp32)."""
    pred = logits.argmax(dim=-1)
    return 100.0 * (pred == labels).float().mean()


def flatten_grouped(x: torch.Tensor, label: torch.Tensor):
    """``[B, nPerSpeaker, D] -> [B*nPerSpeaker, D]`` with each label
    repeated ``nPerSpeaker`` times."""
    if x.dim() == 3:
        label = torch.repeat_interleave(label, x.shape[1])
        x = x.reshape(-1, x.shape[-1])
    return x, label


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the wider of the two dtypes, as jnp promotes (an fp32
    embedding against a head's bf16 weights)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
