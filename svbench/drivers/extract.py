"""Trial-list scoring through the program's ``evaluate_from_list``, the
path of ``--do_infer --eval`` (with ``quant: int8``, the int8 path).

Set-up writes a seeded list: ``files`` WAV utterances of ``utt_seconds``
under a temporary directory of ``TMPDIR`` and ``trials_per_file`` ×
``files`` seeded trials; builds the program's ``InferenceEngine`` with
the seeded weights; and runs one warm-up list of ``warm_files`` files,
on whose first batch an int8 engine calibrates. The window runs whole
passes over the list, back to back, the engine's loader reading and
cropping the WAVs on its worker threads, until its seconds are up; each
pass's seconds, and how they split between the engine's calls (host and
device) and the waits on the loader, go to standard error.

A control run puts the configuration's control for the run's precision
in the program's place: for int8, the reference in ``reference_bits``
-bit integers.

Traffic keys: ``files``, ``utt_seconds``, ``trials_per_file``,
``warm_files``, ``check_trials`` (trials compared after the window)."""

from __future__ import annotations

import copy
import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from svbench.drivers.serve import TimedEmbed, mel_shape
from svbench.harness import cells, flops, roofline, seeded
from svbench.harness.core import Check, log
from svbench.harness.trace import Trace
from svbench.reference import int8 as ref_int8
from svbench.reference.models import build_reference, no_tf32

__all__ = ["hparams", "run"]

KERNEL_TAGS = {"k1": "mel_kernel", "k3": "qmm_"}


def hparams(run) -> dict:
    """The configuration's hyperparameters with the traffic's, and in a
    control run the control's switch where it has one."""
    h = copy.deepcopy(run.cell.config["hparams"])
    h.update(copy.deepcopy(run.cell.traffic.get("hparams", {})))
    if run.control:
        switch = cells.control(run.cell, h).get("hparams", {})
        h.update(copy.deepcopy(switch))
    return h


def _write_wav(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """16-bit mono PCM, the test signal's exact samples."""
    data = np.round(pcm * 32768.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE")
        f.write(b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
                + (1).to_bytes(2, "little")
                + sample_rate.to_bytes(4, "little")
                + (2 * sample_rate).to_bytes(4, "little")
                + (2).to_bytes(2, "little") + (16).to_bytes(2, "little"))
        f.write(b"data" + len(data).to_bytes(4, "little") + data)


def eval_crops(pcm: np.ndarray, crop: int, num_eval: int) -> np.ndarray:
    """``num_eval`` evenly spaced crops of ``crop`` samples, a short
    signal wrapped to ``crop + 1`` first (the eval loader's cropping)."""
    if len(pcm) <= crop:
        pcm = np.pad(pcm, (0, crop - len(pcm) + 1), "wrap")
    starts = np.linspace(0, len(pcm) - crop, num_eval)
    return np.stack([pcm[int(s):int(s) + crop] for s in starts])


class TimedCalls:
    """``embed_fn`` with each call's device time (CUDA events), its host
    time, and the host time between one call's return and the next call
    (the wait on the loader), within a pass."""

    def __init__(self, fn):
        self.device = TimedEmbed(fn)
        self.gaps_ms: list = []
        self.host_ms: list = []
        self.calls: list = []       # calls made before each pass
        self._left = None

    def new_pass(self) -> None:
        self._left = None
        self.calls.append(len(self.host_ms))

    def __call__(self, waves):
        now = time.perf_counter()
        if self._left is not None:
            self.gaps_ms.append((now - self._left) * 1e3)
        out = self.device(waves)
        self._left = time.perf_counter()
        self.host_ms.append((self._left - now) * 1e3)
        return out

    def per_pass(self) -> list:
        """``(host ms in calls, device ms of calls)`` of each pass."""
        device = self.device.ms()
        ends = self.calls[1:] + [len(self.host_ms)]
        return [(sum(self.host_ms[a:b]), sum(device[a:b]))
                for a, b in zip(self.calls, ends)]


def run(run) -> None:
    from speakerverification_tpu_torch.evaluation.evaluator import (
        evaluate_from_list,
    )
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.ops import mel_frontend, quant_matmul
    h = hparams(run)
    t = run.cell.traffic
    run.stage("imports")
    dev = torch.device(run.device)
    on_cuda = dev.type == "cuda"
    spec = h["audio_spec"]
    sr = int(spec["sample_rate"])
    crop = int(float(spec["sentence_len"]) * sr)
    num_eval, batch = int(h["num_eval"]), int(h["eval_batch_size"])
    workers = int(h["dataloader_options"]["num_workers"])

    ref = build_reference(h).to(dev)
    state = seeded.seeded_state(ref, run.seed)
    weights = {k: v.cpu() for k, v in state.items()}
    crops_per_forward = batch * num_eval
    if run.trace:
        r = run.readings
        r["model.flops_per_forward"] = flops.forward_flops(ref, crop) \
            * crops_per_forward
        r["k3.least_s"] = sum(
            roofline.int8_gemm_least_s(m, k, n) for m, k, n in
            ref_int8.gemm_shapes(ref, crop, crops_per_forward))
        r["k1.least_s"] = roofline.mel_frontend_least_s(
            crops_per_forward, crop, *mel_shape(h))
        r["model.peak"] = roofline.peak_for(cells.precision(h))
    del ref, state
    run.stage("seeded weights")

    work = tempfile.mkdtemp(prefix="svbench-extract-")
    try:
        rng = np.random.default_rng([run.seed, 4])
        n = int(t["files"])
        lo, hi = t["utt_seconds"]
        names = [f"utt{i:05d}.wav" for i in range(n)]
        lengths = rng.uniform(lo, hi, n)
        for name, seconds in zip(names, lengths):
            _write_wav(os.path.join(work, name),
                       seeded.int16_audio(rng, int(seconds * sr), sr), sr)
        trials = []
        per = int(t["trials_per_file"])
        for i in range(n):
            for j in rng.choice(n - 1, size=per, replace=False):
                j = j + (j >= i)
                trials.append((int(rng.integers(0, 2)), names[i], names[j]))
        listfile = os.path.join(work, "trials.txt")
        with open(listfile, "w") as f:
            f.writelines(f"{lab} {os.path.join(work, a)} "
                         f"{os.path.join(work, b)}\n" for lab, a, b in trials)
        warm = sorted(names)[:int(t["warm_files"])]
        warmfile = os.path.join(work, "warm.txt")
        with open(warmfile, "w") as f:
            f.writelines(f"1 {os.path.join(work, a)} {os.path.join(work, b)}\n"
                         for a, b in zip(warm, warm[1:] + warm[:1]))
        run.stage("trial list")

        fd, path = tempfile.mkstemp(suffix=".pt", prefix="svbench-")
        os.close(fd)
        try:
            torch.save(weights, path)
            engine = InferenceEngine(h, weights=path, device=run.device)
        finally:
            os.remove(path)
        if on_cuda and h.get("quant") == "int8":
            quant_matmul.build()
        run.stage("engine")

        def one_pass(fn, lst):
            return evaluate_from_list(
                fn, lst, spec, num_eval=num_eval, scoring_mode="cosine",
                normalize=False, batch_size=batch, num_workers=workers)

        calib_files = warm[:batch]
        embed = engine.embed_fn
        bits = (cells.control(run.cell, h).get("reference_bits")
                if run.control else None)
        if bits:
            # the reference in fewer bits in the program's place
            qref = reference_quantized(h, weights, work, calib_files, crop,
                                       num_eval, int(bits), dev)
            def embed(waves):
                with torch.inference_mode():
                    return qref.embed(torch.as_tensor(waves).to(dev))
        if run.fault == "answer":
            embed = _altered(embed)
        one_pass(embed, warmfile)       # calibrates an int8 engine
        run.stage("warm-up")

        timed = TimedCalls(embed) if on_cuda else None
        call = timed if timed is not None else embed
        k1_0, k3_0 = mel_frontend.launches, quant_matmul.launches
        passes, ends = [], []
        sync = torch.cuda.synchronize if on_cuda else (lambda: None)
        sync()
        with Trace(run.trace and on_cuda, sync) as tr:
            run.window_opens()
            t0 = time.perf_counter()
            while True:
                if timed is not None:
                    timed.new_pass()
                scores, _, _ = one_pass(call, listfile)
                passes.append(scores)
                ends.append(time.perf_counter() - t0)
                if time.perf_counter() - t0 >= run.seconds:
                    break
            sync()
            t1 = time.perf_counter()
        run.trace_summary = tr.summary(KERNEL_TAGS)
        if on_cuda:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        run.attempted = len(passes) * n
        run.failed = sum(int((~np.isfinite(s)).sum()) for s in passes)
        run.e2e["extract_utts_per_s"] = len(passes) * n / (t1 - t0)
        r = run.readings
        r["k1.launches"] = mel_frontend.launches - k1_0
        r["k3.launches"] = quant_matmul.launches - k3_0
        forwards = len(passes) * -(-n // batch)
        r["forwards"] = forwards
        if timed is not None and run.trace:
            r["engine.forward_ms"] = timed.device.ms()
            r["loader.gap_ms"] = timed.gaps_ms
        log(f"[extract] {len(passes)} passes of {n} files, {len(trials)} "
            f"trials in {t1 - t0:.3f} s: "
            f"{run.e2e['extract_utts_per_s']:.3f} utts/s")
        if timed is not None:
            walls = np.diff([0.0] + ends)
            for k, (wall, (host, device)) in enumerate(
                    zip(walls, timed.per_pass())):
                log(f"[extract] pass {k}: {wall:.3f} s; in the engine's "
                    f"calls {host / 1e3:.3f} s on the host, "
                    f"{device / 1e3:.3f} s on the device; the rest "
                    f"(the loader's waits, the scoring) "
                    f"{wall - host / 1e3:.3f} s")
        del engine, embed, call
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        check(run, h, weights, work, calib_files, trials, passes, crop,
              num_eval)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _altered(embed):
    """A fault for the tests: the first answer of every batch is altered
    where it is produced."""
    def fn(waves):
        out = embed(waves).clone()
        out[0] = out[0].roll(1)      # another direction
        return out
    return fn


def _pcm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    at = raw.index(b"data") + 8
    return np.frombuffer(raw[at:], dtype="<i2").astype(np.float32) / 32768.0


@torch.no_grad()
def reference_quantized(h, weights, work, calib_files, crop, num_eval,
                        bits, dev):
    """The reference with the seeded weights, calibrated (TF32 off) on the
    rows the engine calibrates on (an evenly spaced subsample of
    ``quant_calib_utts`` crops of its first batch), in ``bits``-bit
    integers."""
    with no_tf32():
        ref = build_reference(h).to(dev).eval()
        ref.load_state_dict(weights)
        rows = np.concatenate([eval_crops(_pcm(os.path.join(work, f)), crop,
                                          num_eval) for f in calib_files])
        idx = np.linspace(0, len(rows) - 1, min(int(h.get(
            "quant_calib_utts", 32)), len(rows))).astype(int)
        scales = ref_int8.calibrate(ref, torch.as_tensor(rows[idx]).to(dev))
    return ref_int8.quantized(ref, scales, bits=bits)


def check(run, h, weights, work, calib_files, trials, passes, crop,
          num_eval) -> None:
    """Embed the files of a seeded sample of trials with the int8
    reference and compare their scores in every pass of the window (TF32
    off)."""
    dev = torch.device(run.device)
    t = run.cell.traffic
    rng = np.random.default_rng([run.seed, 5])
    pick = rng.choice(len(trials), size=min(int(t["check_trials"]),
                                            len(trials)), replace=False)
    qref = reference_quantized(h, weights, work, calib_files, crop,
                               num_eval, 8, dev)
    with torch.no_grad(), no_tf32():
        files = sorted({f for i in pick for f in trials[i][1:]})
        emb = {}
        block = int(h["eval_batch_size"])
        for at in range(0, len(files), block):
            chunk = files[at:at + block]
            x = np.concatenate([eval_crops(_pcm(os.path.join(work, f)), crop,
                                           num_eval) for f in chunk])
            e = qref.embed(torch.as_tensor(x).to(dev)).cpu().numpy()
            for j, f in enumerate(chunk):
                emb[f] = e[j * num_eval:(j + 1) * num_eval]
    gap = 0.0
    for i in pick:
        a, b = emb[trials[i][1]], emb[trials[i][2]]
        want = float(np.mean(np.abs(np.sum(a * b, axis=-1))))
        for scores in passes:
            got = float(scores[i])
            gap = max(gap, abs(got - want) if np.isfinite(got)
                      else float("inf"))
    run.readings["numbers"] = {"score_gap_max": gap}
    run.checks += [Check(k, run.readings["numbers"][k], float(v))
                   for k, v in run.cell.limits.items()]
    log(f"[extract] compared {len(pick)} trials in {len(passes)} passes "
        f"({len(files)} files) with the int8 reference")
