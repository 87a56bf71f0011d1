"""The traced window: ``torch.profiler`` over CPU and CUDA activity,
reduced to the device's busy time, the kernels by time, the longest
idle gaps named by what the host was doing, and the events of named
kernels.

The profiler starts before the window's first launch and stops after
its closing synchronise."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

__all__ = ["Trace", "TraceSummary", "merge", "gaps"]


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list          # [[name, seconds]] by time, at most 10
    idle_gaps: list           # [[host op, seconds]] longest first, at most 10
    kernels: dict             # tag -> (events, seconds)


def merge(intervals: list) -> list:
    """Union of ``[(start, end)]`` as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def gaps(merged: list, lo: float, hi: float) -> list:
    """``[(start, length)]`` of the stretches of ``[lo, hi]`` that no
    merged interval covers."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi) - at))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi - at))
    return [g for g in out if g[1] > 0]


class Trace:
    """``with Trace(enabled, sync) as t: ...`` then ``t.summary(tags)``.
    Disabled, it does nothing and summarizes to None."""

    def __init__(self, enabled: bool, sync):
        self.enabled = enabled
        self.sync = sync
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self.sync()
            self._prof.__enter__()
            self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.sync()
            self.t1_ns = time.time_ns()
            self._prof.__exit__(*exc)
        return False

    def summary(self, tags: dict) -> Optional[TraceSummary]:
        """``tags``: label -> substring of the kernel names it counts."""
        if not self.enabled:
            return None
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                dev.append((s, s + d, e.name()))
            elif not e.is_async():
                host.append((s, s + d, e.name()))
        lo, hi = self.t0_ns, self.t1_ns
        dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev
               if e > lo and s < hi]
        merged = merge([(s, e) for s, e, _ in dev])
        busy = sum(e - s for s, e in merged)
        by_name: dict = {}
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        longest = sorted(gaps(merged, lo, hi), key=lambda g: -g[1])[:10]
        named = []
        if host:
            hs = np.array([h[0] for h in host], dtype=np.int64)
            he = np.array([h[1] for h in host], dtype=np.int64)
        for at, length in longest:
            # the innermost host operation running when the gap began
            name = "(no host op)"
            if host:
                inside = np.nonzero((hs <= at) & (he > at))[0]
                if len(inside):
                    name = host[inside[np.argmin((he - hs)[inside])]][2]
            named.append([name, length / 1e9])
        kernels = {}
        for label, tag in tags.items():
            mine = [(s, e) for s, e, n in dev if tag in n]
            kernels[label] = (len(mine), sum(e - s for s, e in mine) / 1e9)
        return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                            device_ops=[[n, t / 1e9] for n, t in top],
                            idle_gaps=named, kernels=kernels)
