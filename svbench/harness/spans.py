"""What the readers of the program's own spans share.

The program records its spans (``speakerverification_tpu_torch/utils/
tracing.py``) while a profiler runs, which in a run is the traced
window alone; a reader takes them once the window has closed. A run
without a trace, or a program without spans, reads None. ``r["spans"]``,
where given, stands in for the program's (the tests' synthetic lists):
anything with ``name``, ``start_ns``, ``end_ns``, ``span_id``,
``parent``, ``trace``, ``attrs`` and ``device_ms``."""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np

__all__ = ["window_spans", "host_ms", "device_ms", "named",
           "per_step_stream_ms", "turnaround_ms"]


def window_spans(r: dict) -> Optional[list]:
    """The spans of the run's traced window; None where it has none."""
    if r.get("trace") is None:
        return None
    if "spans" in r:
        return r["spans"] or None
    try:
        from speakerverification_tpu_torch.utils import tracing
    except ImportError:          # a program that records no spans
        return None
    return tracing.spans() or None


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def host_ms(spans: Optional[list], name: str, stat: str = "mean",
            keep=lambda s: True) -> Optional[float]:
    """The mean (or ``"p95"``) host duration in ms of the spans called
    ``name`` that ``keep`` accepts."""
    if not spans:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in named(spans, name)
          if keep(s)]
    if not ms:
        return None
    if stat == "p95":
        return float(np.percentile(ms, 95))
    return statistics.fmean(ms)


def device_ms(spans: Optional[list], name: str) -> Optional[float]:
    """The mean time between the CUDA events of the spans called
    ``name``; None where any has none."""
    if not spans:
        return None
    ms = [s.device_ms for s in named(spans, name)]
    if not ms or any(t is None for t in ms):
        return None
    return statistics.fmean(ms)


def per_step_stream_ms(spans: Optional[list], phase: str) -> Optional[float]:
    """The stream time (from the CUDA event at a span's start to the one
    at its end: the phase's kernels and the stream's idle time between
    them) of the ``phase`` spans inside the window's ``train.step``
    spans, over the number of steps."""
    if not spans:
        return None
    steps = {s.span_id for s in named(spans, "train.step")}
    times = [s.device_ms for s in named(spans, phase) if s.parent in steps]
    if not steps or not times or any(t is None for t in times):
        return None
    return sum(times) / len(steps)


def turnaround_ms(spans: Optional[list]) -> Optional[float]:
    """The mean time from one batch's ``batcher.copy_back`` end to the
    next batch's first ``engine.forward`` start, over the batches whose
    first request was already waiting when the worker came for it (its
    ``batcher.batch`` not ``blocked``): the host's time between two
    forwards while requests wait."""
    if not spans:
        return None
    batches = {s.trace: s for s in named(spans, "batcher.batch")}
    back = {s.trace: s for s in named(spans, "batcher.copy_back")}
    forward: dict = {}
    for s in named(spans, "engine.forward"):
        if s.trace in batches and (s.trace not in forward or
                                   s.start_ns < forward[s.trace].start_ns):
            forward[s.trace] = s
    gaps = [(forward[b].start_ns - back[b - 1].end_ns) / 1e6
            for b, batch in batches.items()
            if batch.attrs.get("blocked") is False and b in forward
            and b - 1 in back]
    return statistics.fmean(gaps) if gaps else None
