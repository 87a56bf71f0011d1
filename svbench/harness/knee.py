"""The knee of an open-loop sweep: the highest offered rate that the
system keeps up with, and whose backlog does not grow.

A rate keeps up when requests complete at no less than ``keep`` of the
offered rate; its backlog grows when the latency of the window's last
quarter of requests exceeds ``grow`` times that of its first quarter
(medians). The cells' fixed rates sit at a fraction of the knee."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SweepPoint", "sustained", "find_knee", "quarter_medians"]


@dataclasses.dataclass
class SweepPoint:
    offered_per_s: float
    completed_per_s: float
    first_quarter_ms: float
    last_quarter_ms: float


def quarter_medians(latency_ms) -> tuple[float, float]:
    """Median latency of the first and the last quarter of requests, in
    the order they were due."""
    lat = np.asarray(latency_ms, dtype=np.float64)
    q = max(1, len(lat) // 4)
    return float(np.median(lat[:q])), float(np.median(lat[-q:]))


def sustained(p: SweepPoint, keep: float = 0.98, grow: float = 1.5) -> bool:
    return (p.completed_per_s >= keep * p.offered_per_s
            and p.last_quarter_ms <= grow * p.first_quarter_ms)


def find_knee(points, keep: float = 0.98, grow: float = 1.5) -> float:
    """The highest offered rate below which every swept rate is
    sustained; ``ValueError`` when the lowest is not."""
    knee = None
    for p in sorted(points, key=lambda p: p.offered_per_s):
        if not sustained(p, keep, grow):
            break
        knee = p.offered_per_s
    if knee is None:
        raise ValueError("no swept rate is sustained")
    return knee
