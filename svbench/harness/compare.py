"""The numbers that decide ``correct``, each compared with its limit.

- Served or extracted embeddings: the widest L2 distance between a crop
  embedding the program returned and the reference's, both unit-norm.
- Training (the first three steps, from the same weights and batches):
  each step's loss as a relative gap; the first gradient's norm and the
  parameters' change after three steps, leaf by leaf, as the gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger. Leaves
  whose reference gradient is under a thousandth of the median leaf's
  (nought to rounding, as a bias under a softmax) are left out of the
  change: the optimizer moves them on rounding alone. Beside the worst
  leaf, the median over the leaves of the same gap, and the first
  step's loss alone: steadier numbers where one small leaf's rounding
  or the later steps' drift sets the worst."""

from __future__ import annotations

import numpy as np

__all__ = ["embedding_gap", "loss_gap", "leaf_norm_gaps", "worst",
           "moving_leaves"]


def embedding_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest row distance ``|got - ref|`` (rows are embeddings)."""
    got = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    ref = np.asarray(ref, np.float64).reshape(-1, ref.shape[-1])
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.linalg.norm(got - ref, axis=1).max())


def loss_gap(got, ref) -> float:
    """Largest ``|got - ref| / |ref|`` over the steps."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def moving_leaves(ref_grad_norms: dict, floor: float = 1e-3) -> list:
    """Leaves whose reference gradient norm is at least ``floor`` times
    the median leaf's."""
    med = float(np.median(list(ref_grad_norms.values())))
    return sorted(k for k, v in ref_grad_norms.items() if v >= floor * med)


def leaf_norm_gaps(got: dict, ref: dict, keys=None) -> dict:
    """Each leaf's ``|‖got‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)`` over
    ``keys`` (default: all), the median taken over the same leaves."""
    keys = sorted(ref) if keys is None else list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return {k: (abs(float(got[k]) - ref[k]) / max(ref[k], med)
                if np.isfinite(got[k]) else float("inf")) for k in keys}


def worst(gaps: dict, n: int = 5) -> list:
    """The ``n`` largest gaps as ``[(leaf, gap)]``."""
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
