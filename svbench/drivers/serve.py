"""Open-loop serving through the program's ``DynamicBatcher``.

Set-up builds the program's engine and batcher as ``--do_serve`` builds
them (``InferenceEngine``, ``make_serving_app``, ``warm_up``) with the
seeded weights, and cuts a pool of seeded utterances into the
configuration's evenly spaced eval crops. The window submits requests
straight to ``batcher.submit`` (no HTTP) at the traffic file's due
times, whether or not earlier ones came back, and times each from when
it was due to when its embeddings came back.

Traffic keys: ``rate_per_s``, ``arrivals`` (one of :data:`ARRIVALS`;
``poisson``: exponential gaps whose values every seed shares, in a
seeded order), ``utt_seconds`` ``[lo, hi]``, ``pool_utts``,
``batch_utts``, ``max_wait_ms``,
``transport``, ``check_requests`` (answers compared after the window),
``drain_s`` (how long past the window an answer may still come)."""

from __future__ import annotations

import concurrent.futures
import copy
import gc
import os
import tempfile
import time

import numpy as np
import torch

from svbench.harness import cells, compare, flops, roofline, seeded
from svbench.harness.core import Check, log
from svbench.harness.trace import Trace
from svbench.reference.models import build_reference, no_tf32

__all__ = ["ARRIVALS", "hparams", "mel_shape", "Server", "Window", "run"]

KERNEL_TAGS = {"k1": "mel_kernel"}
# the arrival processes a traffic file may name: (rng, rate, count) -> gaps
ARRIVALS = {"poisson": seeded.fixed_gaps}


def mel_shape(h: dict) -> tuple:
    """``(n_fft, hop, n_mels)`` of the configuration's mel features."""
    spec = h["audio_spec"]
    return (int(h.get("n_fft", 512)),
            int(round(float(spec["hop_len"]) * int(spec["sample_rate"]))),
            int(h.get("n_mels", 80)))


def hparams(run) -> dict:
    """The program's hyperparameters of this run: the configuration's,
    with the traffic's serving keys and, in a control run, the
    configuration's switch to its lower precision."""
    h = copy.deepcopy(run.cell.config["hparams"])
    t = run.cell.traffic
    h["serving"] = {"batch_utts": int(t["batch_utts"]),
                    "max_wait_ms": float(t["max_wait_ms"]),
                    "transport": str(t["transport"])}
    if run.control:
        h.update(copy.deepcopy(cells.control(run.cell, h)["hparams"]))
    return h


class TimedEmbed:
    """The batcher's ``embed`` with each call's device time recorded
    (CUDA events; the batcher's copy back to the host ends each call)."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, waves):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(waves)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


class Window:
    """The requests of one window and when each came back."""

    def __init__(self, due: np.ndarray, which: np.ndarray):
        self.due = due                          # seconds after the open
        self.which = which                      # pool utterance of each
        self.done = np.full(len(due), np.nan)   # perf_counter at return
        self.futures = [None] * len(due)
        self.t0 = 0.0
        self.late_s = 0.0

    def latency_ms(self) -> np.ndarray:
        return (self.done - (self.t0 + self.due)) * 1e3


class Server:
    """The program's serving stack with seeded weights, and a pool of
    seeded requests."""

    def __init__(self, run, h: dict):
        from speakerverification_tpu_torch.inference import InferenceEngine
        from speakerverification_tpu_torch.serving import (
            make_serving_app,
            warm_up,
        )
        t = run.cell.traffic
        self.h, self.run = h, run
        run.stage("imports")
        dev = torch.device(run.device)
        ref = build_reference(h).to(dev)
        state = seeded.seeded_state(ref, run.seed)
        self.state = {k: v.cpu() for k, v in state.items()}
        self.flops_per_crop = None
        del state
        spec = h["audio_spec"]
        self.sr = int(spec["sample_rate"])
        self.crop = int(float(spec["sentence_len"]) * self.sr)
        self.num_eval = int(h["num_eval"])
        if run.trace:
            self.flops_per_crop = flops.forward_flops(ref, self.crop)
        del ref
        run.stage("seeded weights")
        fd, path = tempfile.mkstemp(suffix=".pt", prefix="svbench-")
        os.close(fd)
        try:
            torch.save(self.state, path)
            self.engine = InferenceEngine(h, weights=path, device=run.device)
        finally:
            os.remove(path)
        run.stage("engine")
        _, self.batcher = make_serving_app(self.engine, h)
        if run.fault == "answer":
            self.batcher.embed = _altered(self.batcher.embed)
        warm_up(self.engine, self.batcher)
        run.stage("warm-up")
        rng = np.random.default_rng([run.seed, 0])
        lo, hi = t["utt_seconds"]
        n = int(t["pool_utts"])
        self.lengths = rng.uniform(lo, hi, n)
        self.crops = np.empty((n, self.num_eval, self.crop), np.float32)
        for i, seconds in enumerate(self.lengths):
            audio = seeded.int16_audio(rng, int(seconds * self.sr), self.sr)
            starts = np.linspace(0, len(audio) - self.crop, self.num_eval)
            self.crops[i] = np.stack([audio[int(s):int(s) + self.crop]
                                      for s in starts])
        run.stage("request pool")

    def window(self, rate: float, seconds: float, rng) -> Window:
        kind = self.run.cell.traffic["arrivals"]
        if kind not in ARRIVALS:
            raise KeyError(f"no arrival process {kind!r} (have "
                           f"{sorted(ARRIVALS)})")
        count = max(1, int(round(rate * seconds)))
        gaps = ARRIVALS[kind](rng, rate, count)
        due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        return Window(due, rng.integers(0, len(self.crops), size=count))

    def warm(self, batches: int = 3) -> None:
        """A few full batches of real requests before the window."""
        b = self.batcher.batch_utts
        futs = [self.batcher.submit(self.crops[i % len(self.crops)])
                for i in range(batches * b)]
        for f in futs:
            f.result(timeout=600)

    def drive(self, w: Window, on_open=None) -> None:
        """Submit ``w``'s requests at their due times and wait for their
        answers, each at most ``drain_s`` past the window's close."""
        def stamp(i):
            def cb(_f):
                w.done[i] = time.perf_counter()
            return cb

        if on_open is not None:
            on_open()
        w.t0 = t0 = time.perf_counter()
        for i, due in enumerate(w.due):
            target = t0 + due
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            else:
                w.late_s = max(w.late_s, now - target)
            f = self.batcher.submit(self.crops[w.which[i]])
            f.add_done_callback(stamp(i))
            w.futures[i] = f
        deadline = t0 + w.due[-1] + float(self.run.cell.traffic["drain_s"])
        for f in w.futures:
            try:
                f.result(timeout=max(0.0, deadline - time.perf_counter()))
            except concurrent.futures.TimeoutError:
                pass            # never came: counted as lost below
            except Exception:   # the program's error, counted as failed
                pass
        # a future's callbacks run just after its waiters wake: let the
        # stamps of the answers that came land before they are read
        settle = time.perf_counter() + 5.0
        while time.perf_counter() < settle and any(
                np.isnan(w.done[i]) and f.done() and f.exception() is None
                for i, f in enumerate(w.futures)):
            time.sleep(0.001)

    def close(self) -> None:
        self.batcher.close()
        del self.engine, self.batcher
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _altered(embed):
    """A fault for the tests: the first answer of every batch is altered
    where it is produced."""
    def fn(waves):
        out = embed(waves)
        out = out.clone()
        out[0] = out[0].roll(1)      # another direction
        return out
    return fn


def check(run, server: Server, w: Window) -> None:
    """Compare a seeded sample of the window's answers, with the longest
    utterance served among them, with the reference (TF32 off), in
    blocks; adds the check to ``run``."""
    t = run.cell.traffic
    came = [i for i, f in enumerate(w.futures)
            if f.done() and f.exception() is None]
    rng = np.random.default_rng([run.seed, 1])
    k = min(int(t["check_requests"]), len(came))
    pick = set(rng.choice(came, size=k, replace=False).tolist()) if k else set()
    if came:
        pick.add(max(came, key=lambda i: server.lengths[w.which[i]]))
    pick = sorted(pick)
    served = {i: np.asarray(w.futures[i].result()) for i in pick}
    crops = server.crops
    dev = torch.device(run.device)
    ref = build_reference(server.h).to(dev).eval()
    ref.load_state_dict(server.state)
    gap = 0.0
    per_block = max(1, int(t["batch_utts"]))
    with torch.no_grad(), no_tf32():
        for at in range(0, len(pick), per_block):
            block = pick[at:at + per_block]
            x = torch.as_tensor(np.concatenate([crops[w.which[i]]
                                                for i in block])).to(dev)
            e = ref.embed(x).cpu().numpy().reshape(len(block),
                                                   server.num_eval, -1)
            for j, i in enumerate(block):
                gap = max(gap, compare.embedding_gap(served[i], e[j]))
    run.readings["numbers"] = {"embed_gap_max": gap}
    run.checks += [Check(k, run.readings["numbers"][k], float(v))
                   for k, v in run.cell.limits.items()]
    log(f"[serve] compared {len(pick)} answers "
        f"({len(pick) * server.num_eval} crops) with the reference")


def run(run) -> None:
    h = hparams(run)
    t = run.cell.traffic
    server = Server(run, h)
    server.warm()
    rng = np.random.default_rng([run.seed, 2])
    w = server.window(float(t["rate_per_s"]), run.seconds, rng)
    timed = None
    on_cuda = run.device == "cuda"
    if run.trace and on_cuda:
        timed = TimedEmbed(server.batcher.embed)
        server.batcher.embed = timed
    from speakerverification_tpu_torch.ops import mel_frontend
    b0, u0 = server.batcher.batches_run, server.batcher.utts_served
    k1_0 = mel_frontend.launches
    if on_cuda:
        torch.cuda.synchronize()
    with Trace(run.trace and on_cuda, torch.cuda.synchronize) as tr:
        server.drive(w, on_open=run.window_opens)
    run.trace_summary = tr.summary(KERNEL_TAGS)
    if on_cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    lat = w.latency_ms()
    came = np.isfinite(lat)
    errors = sum(1 for f in w.futures if f.done() and f.exception())
    run.attempted = len(lat)
    run.failed = int((~came).sum())
    run.lost = run.failed - errors
    missed = np.where(came, lat, float(t["drain_s"]) * 1e3)
    run.e2e["serve_p95_ms"] = float(np.percentile(missed, 95))
    r = run.readings
    r["batcher.batches"] = server.batcher.batches_run - b0
    r["batcher.utts"] = server.batcher.utts_served - u0
    r["k1.launches"] = mel_frontend.launches - k1_0
    r["late_s"] = w.late_s
    log(f"[serve] {run.attempted} requests at {t['rate_per_s']}/s over "
        f"{run.seconds} s: p50 {np.percentile(missed, 50):.3f} ms, p95 "
        f"{run.e2e['serve_p95_ms']:.3f} ms, {run.failed} failed, "
        f"{r['batcher.batches']} batches, generator late by at most "
        f"{w.late_s * 1e3:.3f} ms")
    if timed is not None:
        ms = timed.ms()
        r["engine.forward_ms"] = ms
        # the model's work is the utterances served, not the copies of
        # one request that fill the rest of a batch
        served = r["batcher.utts"] / max(1, r["batcher.batches"])
        r["model.flops_per_forward"] = (server.flops_per_crop * served
                                        * server.num_eval)
        r["model.peak"] = roofline.peak_for(cells.precision(h))
        crops = server.batcher.batch_utts * server.num_eval
        r["k1.least_s"] = roofline.mel_frontend_least_s(
            crops, server.crop, *mel_shape(h))
    server.close()
    check(run, server, w)
