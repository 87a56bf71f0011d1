"""One run of a cell: its clock, what it read, and its result line.

A run's last line on standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit. The same checks are the last lines
on standard error."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional

__all__ = ["FORBIDDEN", "forbidden_loaded", "process_start", "Run",
           "Check", "log", "card_state", "emit"]

# the JAX stack and the JAX package: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speakerverification_tpu")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted(name for name in list(sys.modules)
                  if name.partition(".")[0] in FORBIDDEN)


def process_start() -> float:
    """This process's start, in ``time.time()`` seconds, from
    ``/proc/self/stat`` and the boot time; the current time where those
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def card_state() -> str:
    """The card's SM clock, power draw, temperature and power limit, as
    ``nvidia-smi`` reads them (beside every number a run keeps)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
             "temperature.gpu,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return out.stdout.strip().replace("\n", "; ")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver gets and fills in."""
    cell: object                     # harness.cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    control: bool = False            # the configuration's control path
    fault: Optional[str] = None      # a fault planted for the tests
    started: float = dataclasses.field(default_factory=process_start)
    setup_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    lost: int = 0                    # answers that never came
    e2e: dict = dataclasses.field(default_factory=dict)
    readings: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    trace_summary: object = None

    def stage(self, name: str) -> None:
        """Log a set-up stage's end, in seconds since the process began."""
        log(f"[setup] {name} at {time.time() - self.started:.2f} s")

    def window_opens(self) -> None:
        """Set-up ends: the first timed request or step follows."""
        self.setup_s = time.time() - self.started

    @property
    def correct(self) -> bool:
        return (self.lost == 0 and bool(self.checks)
                and all(c.ok for c in self.checks))

    def result(self, metrics: dict, device: dict) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics, "device": device}
        if self.trace_summary is not None:
            out["breakdown"] = {"device_ops": self.trace_summary.device_ops,
                                "idle_gaps": self.trace_summary.idle_gaps}
        out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                         for c in self.checks}
        if self.lost:
            out["checks"]["answers_lost"] = {"value": self.lost, "limit": 0}
        return out


def emit(result: dict) -> None:
    """The checks as the last lines on standard error, then the result
    as the last line on standard output."""
    for name, c in result["checks"].items():
        log(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
