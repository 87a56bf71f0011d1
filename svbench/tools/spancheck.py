#!/usr/bin/env python3
"""One traced run of a cell, as ``run.py --trace 1`` makes it, held
against the program's spans and the profiler's own events.

    python3 svbench/tools/spancheck.py --workload raw3_ecapa-serve-poisson \
        --seed 7 --seconds 51 [--out chiprun_out/spans-serve-7.json]

Prints the run's result line, then one JSON line: the program's spans by
name (count, mean host ms, mean stream ms between its CUDA events); how
many of the profiler's
``mel_kernel`` launches lie inside an ``engine.forward`` span (the host
call's time, on the clock both share); in a serve cell, the
``batcher.queued`` spans against the batcher's count of utterances
served in the window, and how late the request generator ran; in a
train cell, the three phases' stream time a step against the trace's
busy and window time a step, and the device activity each phase
launched (kernels matched to their launch calls by correlation id,
idle time left out) a step; the garbage collector's passes in the
window (each pass holds the interpreter lock); and the breakdown's
longest idle gaps with the host operation or span each began in.
``--out`` writes the same line to a file. A program without spans reads
empty counts."""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def _launched(events) -> tuple:
    """([(correlation ids, device ns, name)] of the device events, [(host
    start of its launch call, device ns, name)] of each whose launch call
    the profiler has), from the profiler's events."""
    cuda = torch.autograd.DeviceType.CUDA
    device, calls = [], {}
    for e in events:
        if e.device_type() == cuda:
            device.append((e.correlation_id(), e.linked_correlation_id(),
                           e.duration_ns(), e.name()))
        elif e.correlation_id():
            corr, at = e.correlation_id(), e.start_ns()
            if corr not in calls or at < calls[corr]:
                calls[corr] = at
    out = []
    for corr, linked, ns, name in device:
        at = calls.get(corr) or calls.get(linked)
        if at:
            out.append((at, ns, name))
    return device, out


def _busy_inside(launched: list, spans: list) -> float:
    """ms of device activity launched from inside ``spans``."""
    if not launched or not spans:
        return 0.0
    at = np.array([a for a, _, _ in launched], dtype=np.int64)
    order = np.argsort(at)
    at = at[order]
    ns = np.concatenate(([0], np.cumsum(np.array(
        [n for _, n, _ in launched], dtype=np.int64)[order])))
    lo = np.searchsorted(at, [s.start_ns for s in spans], side="left")
    hi = np.searchsorted(at, [s.end_ns for s in spans], side="right")
    return float((ns[hi] - ns[lo]).sum()) / 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from svbench import run as runner
    from svbench.harness import core, trace

    kept: dict = {}
    summary = trace.Trace.summary

    def keep_events(self, tags):
        if self.enabled:
            kept["window"] = (self.t0_ns, self.t1_ns)
            kept["device"], kept["launched"] = _launched(
                self._prof.profiler.kineto_results.events())
        return summary(self, tags)

    result = core.Run.result

    def keep_run(self, metrics, device):
        kept["run"] = self
        return result(self, metrics, device)

    passes, began = [], {}

    def collector(phase, info):
        if phase == "start":
            began["ns"] = time.time_ns()
        else:
            passes.append((began["ns"], info["generation"],
                           (time.time_ns() - began["ns"]) / 1e6))

    trace.Trace.summary = keep_events
    core.Run.result = keep_run
    gc.callbacks.append(collector)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.main(["--workload", args.workload, "--seed",
                          str(args.seed), "--seconds", str(args.seconds),
                          "--trace", "1"])
    gc.callbacks.remove(collector)
    print(out.getvalue(), end="", flush=True)
    if rc != 0:
        return rc
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    try:
        from speakerverification_tpu_torch.utils import tracing
        spans = tracing.spans()
    except ImportError:
        spans = []
    run = kept["run"]
    by: dict = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    report = {"workload": args.workload, "seed": args.seed,
              "correct": line["correct"], "metrics": {
                  k: v["value"] for k, v in line["metrics"].items()},
              "device": line["device"], "idle_gaps":
              line.get("breakdown", {}).get("idle_gaps"), "spans": {}}
    for name, group in sorted(by.items()):
        dev = [s.device_ms for s in group if s.device_ms is not None]
        report["spans"][name] = {
            "count": len(group),
            "host_ms": statistics.fmean(s.ms for s in group),
            "device_ms": statistics.fmean(dev) if dev else None}
    launched = kept.get("launched", [])
    kernels = sum(1 for d in kept.get("device", ()) if "mel_kernel" in d[3])
    launches = [at for at, _, name in launched if "mel_kernel" in name]
    forwards = by.get("engine.forward", []) + by.get("train.forward", [])
    inside = [sum(1 for t in launches if f.start_ns <= t <= f.end_ns)
              for f in forwards]
    report["mel_launches"] = {
        "kernels": kernels, "launch_calls_found": len(launches),
        "in_a_forward_span": sum(inside),
        "forward_spans": len(forwards),
        "forward_spans_with_one": sum(1 for n in inside if n == 1)}
    lo, hi = kept["window"]
    in_window = [(g, ms) for at, g, ms in passes if lo <= at <= hi]
    report["gc"] = {"passes": len(in_window),
                    "full_ms": [ms for g, ms in in_window if g == 2],
                    "longest_ms": max((ms for _, ms in in_window),
                                      default=0.0)}
    r = run.readings
    if "batcher.utts" in r:
        queued = by.get("batcher.queued", [])
        report["queued"] = {
            "spans": len(queued), "utts_served": r["batcher.utts"],
            "all_ended": all(q.start_ns <= q.end_ns for q in queued),
            "batches": len(by.get("batcher.batch", [])),
            "batches_run": r["batcher.batches"],
            "generator_late_ms": r["late_s"] * 1e3}
    if "steps" in r:
        steps = r["steps"]
        phases = sum(s.device_ms or 0.0 for k in
                     ("train.forward", "train.backward", "train.optimizer")
                     for s in by.get(k, ())) / steps
        busy = line["device"]["busy_s"] * 1e3 / steps
        window = line["device"]["window_s"] * 1e3 / steps
        inside = {k: _busy_inside(launched, by.get(f"train.{k}", []))
                  / steps for k in ("forward", "backward", "optimizer")}
        report["phases_a_step"] = {
            "phases_ms": phases, "busy_ms": busy, "window_ms": window,
            "busy_launched_in_ms": inside,
            "within": 0.95 * busy <= phases <= window,
            "steps": steps, "step_spans": len(by.get("train.step", []))}
    text = json.dumps(report)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
