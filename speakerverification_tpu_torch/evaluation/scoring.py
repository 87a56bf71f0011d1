"""Trial scoring on the device: batched gathers and products over the whole
trial list (port of ``evaluation/scoring.py``).

Every unique file's ``num_eval`` crop embeddings are stacked into one
``[n_files, E, D]`` tensor; modes:

* ``cosine``   — mean over crops of |cos(ref_a, com_a)|, elementwise in a;
* ``pnorm``    — mean elementwise euclidean distance (a distance: larger
  is farther, kept for parity);
* ``distance`` — −mean over all crop pairs of ‖ref_a − com_b‖;
* ``norm``/``zt_norm`` — adaptive symmetric S-norm with top-k cohort
  statistics.

Scores are computed in fp32 on the embeddings' device and returned as
numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["l2_normalize", "score_trials", "cohort_stats", "snorm_scores"]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def _score_pairs(emb: torch.Tensor, ridx: torch.Tensor, cidx: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """emb ``[n_files, E, D]``; ridx/cidx ``[n_trials]`` → ``[n_trials]``."""
    ref, com = emb[ridx], emb[cidx]                      # [T, E, D]
    if mode == "cosine":
        cos = (l2_normalize(ref, eps=1e-5) * l2_normalize(com, eps=1e-5)).sum(-1)
        return cos.abs().mean(-1)
    if mode == "pnorm":
        # torch's F.pairwise_distance adds its eps inside the difference
        return torch.linalg.vector_norm(ref - com + 1e-6, dim=-1).mean(-1)
    if mode == "distance":
        d2 = ((ref ** 2).sum(-1)[:, :, None] + (com ** 2).sum(-1)[:, None, :]
              - 2.0 * torch.einsum("ted,tfd->tef", ref, com))
        return -torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12).mean(dim=(1, 2))
    raise ValueError(f"unknown scoring mode {mode!r}")


def cohort_stats(emb_mean: torch.Tensor, cohorts: torch.Tensor,
                 top: int = 200):
    """Per-file top-k cohort statistics in one product: ``(mu, sigma)``,
    each ``[n_files]``; ``sigma`` is the biased std, as ``jnp.std``."""
    scores = emb_mean @ cohorts.T                        # [n_files, N]
    k = min(top, scores.shape[-1]) if top > 0 else scores.shape[-1]
    top_scores = torch.topk(scores, k, dim=-1).values
    return top_scores.mean(-1), top_scores.std(-1, unbiased=False)


def snorm_scores(emb_mean: torch.Tensor, ridx: torch.Tensor,
                 cidx: torch.Tensor, mu: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
    """Adaptive symmetric S-norm: ``raw = mean_r · mean_c``,
    ``s = ((raw − μ_r)/σ_r + (raw − μ_c)/σ_c) / 2``."""
    raw = (emb_mean[ridx] * emb_mean[cidx]).sum(-1)
    return 0.5 * ((raw - mu[ridx]) / sigma[ridx]
                  + (raw - mu[cidx]) / sigma[cidx])


def score_trials(emb, ridx, cidx, mode: str = "cosine",
                 cohorts: Optional[np.ndarray] = None, top: int = 200,
                 normalize: bool = True) -> np.ndarray:
    """Score a whole trial list. ``emb [n_files, E, D]`` (numpy or a
    tensor, scored on its device); ``normalize`` mirrors the loss head's
    ``test_normalize``; ``mode='norm'``/``'zt_norm'`` needs
    ``cohorts [N, D]``."""
    emb = torch.as_tensor(emb).float()
    ridx = torch.as_tensor(np.asarray(ridx), dtype=torch.long, device=emb.device)
    cidx = torch.as_tensor(np.asarray(cidx), dtype=torch.long, device=emb.device)
    if normalize:
        emb = l2_normalize(emb)
    with torch.no_grad():
        if mode in ("norm", "zt_norm"):
            if cohorts is None:
                raise ValueError("zt_norm scoring requires a cohort bank")
            emb_mean = emb.mean(1)
            mu, sigma = cohort_stats(
                emb_mean, torch.as_tensor(cohorts, dtype=torch.float32,
                                          device=emb.device), top)
            out = snorm_scores(emb_mean, ridx, cidx, mu, sigma)
        else:
            out = _score_pairs(emb, ridx, cidx, mode)
    return out.cpu().numpy()
