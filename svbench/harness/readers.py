"""What the per-layer metric files share. A reader returns None where
its run has nothing to read (no trace, no launch of its kernel), and
never 0 for a share of a roofline or a peak."""

from __future__ import annotations

import statistics
from typing import Optional

__all__ = ["kernel_roofline", "idle_share", "mean_ms"]


def kernel_roofline(r: dict, label: str) -> Optional[float]:
    """The kernel's least time over its mean device time per launch, in
    percent. Its launch counter must agree with the trace's events."""
    tr = r.get("trace")
    least = r.get(f"{label}.least_s")
    if tr is None or least is None:
        return None
    events, seconds = tr.kernels.get(label, (0, 0.0))
    launches = r.get(f"{label}.launches")
    if launches is not None and launches != events:
        raise RuntimeError(f"{label}: {launches} launches counted, "
                           f"{events} kernel events traced")
    if events == 0:
        return None
    return 100.0 * least / (seconds / events)


def idle_share(r: dict) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    tr = r.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mean_ms(values) -> Optional[float]:
    return statistics.fmean(values) if values else None
