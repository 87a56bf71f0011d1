"""Dynamic-batching embedding/scoring HTTP daemon (port of ``serving.py``).

- :class:`DynamicBatcher` — concurrent requests enqueue ``[num_eval, T]``
  crop stacks; a dispatcher thread coalesces up to ``batch_utts``
  utterances (or flushes after ``max_wait_ms``) into one
  ``[n * num_eval, T]`` batch of the ``n`` requests it took, no rows
  padded. By default the batch crosses to the device as 16-bit PCM
  (``serving: {transport: int16}``) and is dequantized there.
- :func:`make_serving_app` / :func:`serve` — a ``ThreadingHTTPServer``::

      GET  /healthz   -> {"status": "ok", model, num_eval, ...}
      POST /embed     -> {"embedding": [D floats], "dim": D}
      POST /score     -> {"score": s}   (mean |cos| over all crop pairs)
      POST /identify  -> {"speaker": name, "score": s[, "candidates"]}
      POST /enroll    -> {"speaker": name, "index": i, "enrolled": n}
      POST /unenroll  -> {"speaker": name, "enrolled": n}

  Audio comes as ``{"path": server-local WAV}`` or
  ``{"pcm": [...], "sample_rate": N}``; ``/score`` takes ``enroll`` and
  ``test`` objects.
- The speaker banks behind ``/identify``, ``/enroll`` and ``/unenroll``:
  the ``embeds.npy``/``classes.npy`` that ``--prepare`` with ``prepare:
  embed`` writes, loaded on the first request. ``serving.device_bank``
  (``auto``, ``true``, ``false``) puts them in a
  :class:`~speakerverification_tpu_torch.evaluation.bank.SpeakerBank` on
  the engine's device (``auto``: from ``AUTO_DEVICE_BANK_MIN_ROWS``
  rows); otherwise ``/identify`` scans them on the host.
  ``serving.bank_devices: n > 1`` splits the device bank over the first
  n GPUs (:class:`~speakerverification_tpu_torch.evaluation.bank.
  ShardedSpeakerBank`), refused when fewer are visible. Identifies share
  a readers-writer lock, enrollments take it alone, and with
  ``serving.persist_enroll`` (default true) every change is written back
  to the artifacts, each file to a temporary name first.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from speakerverification_tpu_torch.data.audio import AudioSpec, load_wav
from speakerverification_tpu_torch.evaluation.bank import (
    AUTO_DEVICE_BANK_MIN_ROWS,
    ShardedSpeakerBank,
    SpeakerBank,
)
from speakerverification_tpu_torch.utils import tracing

__all__ = ["DynamicBatcher", "serve", "make_serving_app", "warm_up",
           "bank_device_list"]


def bank_device_list(device: torch.device, n: int) -> list:
    """The first ``n`` devices of ``device``'s kind visible to this
    process (the CPU counts as one); ``ValueError`` when fewer are."""
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    if n > len(visible):
        # the bank was sized for n cards: refuse, not shrink
        raise ValueError(f"serving.bank_devices={n} but only "
                         f"{len(visible)} device(s) visible")
    return visible[:n]


class _RWLock:
    """Readers-writer lock of the serving banks: identifies (readers)
    run together, enrollments and the first load (writers) alone. First
    reader locks, last reader unlocks; writers can starve under
    saturating reads, the right trade for a read-mostly service."""

    def __init__(self):
        self._counter = threading.Lock()
        self._exclusive = threading.Lock()
        self._readers = 0

    class _Ctx:
        def __init__(self, acq, rel):
            self._acq, self._rel = acq, rel

        def __enter__(self):
            self._acq()

        def __exit__(self, *exc):
            self._rel()

    def _acq_read(self):
        with self._counter:
            self._readers += 1
            if self._readers == 1:
                self._exclusive.acquire()

    def _rel_read(self):
        with self._counter:
            self._readers -= 1
            if self._readers == 0:
                self._exclusive.release()

    def read(self):
        return self._Ctx(self._acq_read, self._rel_read)

    def write(self):
        return self._Ctx(self._exclusive.acquire, self._exclusive.release)


class DynamicBatcher:
    """Coalesce concurrent embedding requests into batches.

    ``embed`` maps ``[N, T] -> [N, D]`` (numpy or tensor) with
    ``N = n * num_eval`` for the ``n <= batch_utts`` requests a batch
    carries. ``submit`` is thread-safe and returns a Future resolving to
    the request's ``[num_eval, D]`` crop embeddings. ``batches_run``,
    ``utts_served`` and ``rows_run`` count the batches, requests and rows
    sent to ``embed``.

    While a profiler runs (``utils/tracing.py``) each batch is a
    ``batcher.batch`` span (its trace id the batch's number; ``blocked``
    when the worker found the queue empty) holding
    ``batcher.fill``, ``batcher.assemble`` (``utts``, ``rows``: the
    batch's requests and rows), the ``embed`` call,
    ``batcher.copy_back`` and ``batcher.reply``, and each request a
    ``batcher.queued`` span from its submit to the worker taking it (its
    trace id the request's number, its parent the batch's span)."""

    def __init__(self, embed: Callable, batch_utts: int, num_eval: int,
                 samples: int, max_wait_ms: float = 5.0,
                 transport: str = "float32"):
        if batch_utts < 1:
            raise ValueError("batch_utts must be >= 1")
        if transport not in ("float32", "int16"):
            raise ValueError(f"transport must be float32|int16, "
                             f"got {transport!r}")
        self.embed = embed
        self.batch_utts = int(batch_utts)
        self.num_eval = int(num_eval)
        self.samples = int(samples)
        self.transport = transport
        self.max_wait = float(max_wait_ms) / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self.batches_run = 0
        self.utts_served = 0
        self.rows_run = 0
        self._requests = itertools.count()
        self._batches = itertools.count()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="svtorch-batcher")
        self._thread.start()

    def submit(self, crops: np.ndarray) -> Future:
        crops = np.asarray(crops, np.float32)
        if crops.shape != (self.num_eval, self.samples):
            raise ValueError(
                f"crops shape {crops.shape} != "
                f"({self.num_eval}, {self.samples})")
        if self._closed:
            raise RuntimeError("batcher is closed")
        if self.transport == "int16":
            # wire format: 16-bit PCM, quantized on the caller's thread
            crops = np.clip(np.round(crops * 32768.0),
                            -32768, 32767).astype(np.int16)
        fut: Future = Future()
        # (request number, submit time) for the batcher.queued span
        stamp = ((next(self._requests), time.time_ns())
                 if tracing.enabled() else None)
        self._q.put((crops, fut, stamp))
        return fut

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=10)

    def _worker(self) -> None:
        while True:
            blocked = tracing.enabled() and self._q.empty()
            head = self._q.get()
            if head is None:
                return
            with tracing.span("batcher.batch", trace=next(self._batches),
                              blocked=blocked) as span:
                batch, closed = self._fill(head, span.id)
                self._run(batch)
            if closed:
                return

    def _fill(self, head, batch_span) -> tuple:
        """``head`` and the requests that come within ``max_wait``, up to
        ``batch_utts``; and whether the batcher was closed meanwhile."""
        batch = [_taken(head, batch_span)]
        with tracing.span("batcher.fill"):
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_utts:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    return batch, True
                batch.append(_taken(item, batch_span))
        return batch, False

    def _run(self, batch) -> None:
        n = len(batch)
        rows = n * self.num_eval
        try:
            with tracing.span("batcher.assemble", utts=n, rows=rows):
                dtype = (np.int16 if self.transport == "int16"
                         else np.float32)
                waves = np.empty((rows, self.samples), dtype)
                for i, (crops, _) in enumerate(batch):
                    waves[i * self.num_eval:(i + 1) * self.num_eval] = crops
            emb = self.embed(waves)
            with tracing.span("batcher.copy_back"):
                if isinstance(emb, torch.Tensor):
                    emb = emb.float().cpu().numpy()
                emb = np.asarray(emb, np.float32).reshape(
                    n, self.num_eval, -1)
            self.batches_run += 1
            self.utts_served += n
            self.rows_run += rows
            with tracing.span("batcher.reply"):
                for i, (_, fut) in enumerate(batch):
                    fut.set_result(emb[i])
        except Exception as exc:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)


def _taken(item, batch_span) -> tuple:
    """A queued request as the worker takes it: ``(crops, future)``, its
    wait recorded as a ``batcher.queued`` span of the batch's."""
    crops, fut, stamp = item
    if stamp is not None:
        tracing.record("batcher.queued", stamp[1], time.time_ns(),
                       parent=batch_span, trace=stamp[0])
    return crops, fut


def _decode_audio_spec(obj: Mapping, spec: Mapping,
                       num_eval: int) -> np.ndarray:
    """Request audio object -> ``[num_eval, T]`` eval crops."""
    aspec = AudioSpec(spec)
    if "path" in obj:
        return load_wav(str(obj["path"]), spec, num_eval=num_eval)
    if "pcm" in obj:
        sr = int(obj.get("sample_rate", aspec.sample_rate))
        if sr != aspec.sample_rate:
            raise ValueError(
                f"pcm sample_rate {sr} != configured {aspec.sample_rate} "
                "(resample client-side)")
        pcm = np.asarray(obj["pcm"], np.float32)
        if pcm.ndim != 1 or pcm.size == 0:
            raise ValueError("pcm must be a non-empty 1-D sample list")
        return load_wav(pcm, spec, num_eval=num_eval)
    raise ValueError("audio object needs 'path' or 'pcm'")


def _pair_cosine(e1: np.ndarray, e2: np.ndarray) -> float:
    """Cosine trial score: mean |cos| over all crop pairs (crop
    embeddings arrive L2-normalized)."""
    return float(np.mean(np.abs(e1 @ e2.T)))


def _utt_embedding(crop_emb: np.ndarray) -> np.ndarray:
    """Re-normalized mean of the crop embeddings."""
    mean = crop_emb.mean(axis=0)
    return mean / max(float(np.linalg.norm(mean)), 1e-12)


def make_serving_app(engine, hparams: Mapping,
                     batch_utts: Optional[int] = None,
                     max_wait_ms: Optional[float] = None, device=None):
    """Build ``(handler_class, batcher)`` around an ``InferenceEngine``
    (built here on ``device``, CUDA by default, when ``engine`` is None).
    Tests mount the handler on an ephemeral port."""
    h = dict(hparams)
    if engine is None:
        from speakerverification_tpu_torch.inference import InferenceEngine
        engine = InferenceEngine(h, device=device)
    serving = dict(h.get("serving") or {})
    num_eval = int(h.get("num_eval", 10))
    if num_eval == 0:
        raise ValueError("serving requires num_eval >= 1 (fixed shapes)")
    spec = h.get("audio_spec", {})
    samples = int(float(spec.get("sentence_len", 2.0))
                  * int(spec.get("sample_rate", 8000)))
    batch_utts = int(batch_utts if batch_utts is not None
                     else serving.get("batch_utts", 8))
    max_wait_ms = float(max_wait_ms if max_wait_ms is not None
                        else serving.get("max_wait_ms", 5.0))
    transport = str(serving.get("transport", "int16"))
    batcher = DynamicBatcher(engine.embed_fn, batch_utts, num_eval,
                             samples, max_wait_ms, transport=transport)
    model_name = (h.get("model") or {}).get("name", "?")

    device_bank_cfg = serving.get("device_bank", "auto")
    bank_devices = int(serving.get("bank_devices", 1))
    persist_enroll = bool(serving.get("persist_enroll", True))
    banks = {"embeds": None, "classes": None, "device": None}
    banks_lock = _RWLock()

    def _build_device_bank(embeds, classes):
        if bank_devices > 1:
            return ShardedSpeakerBank(
                embeds, classes,
                devices=bank_device_list(engine.device, bank_devices))
        return SpeakerBank(embeds, classes, device=engine.device)

    def _load_banks():
        # double-checked: banks["embeds"] is assigned last under the
        # write lock, so a non-None read proves the load completed
        if banks["embeds"] is not None:
            return
        with banks_lock.write():
            if banks["embeds"] is None:
                mdir = engine.dirs["model"]
                epath, cpath = mdir / "embeds.npy", mdir / "classes.npy"
                if not (epath.exists() and cpath.exists()):
                    raise FileNotFoundError(
                        "identification needs embeds.npy/classes.npy — run "
                        "--do_infer --prepare with prepare: embed first")
                embeds = np.load(epath)
                classes = np.load(cpath, allow_pickle=True).item()
                use_dev = (len(embeds) >= AUTO_DEVICE_BANK_MIN_ROWS
                           if device_bank_cfg == "auto"
                           else bool(device_bank_cfg))
                if use_dev:
                    banks["device"] = _build_device_bank(embeds, classes)
                banks["classes"] = classes
                banks["embeds"] = embeds         # last: the load is done

    def _persist_banks():
        """Write both artifacts to temporary files, then rename both: a
        crash never leaves a truncated bank or two generations. The
        caller holds the write lock."""
        if not persist_enroll:
            return
        mdir = engine.dirs["model"]
        pairs = []
        for fname, arr in (("embeds.npy", banks["embeds"]),
                           ("classes.npy", banks["classes"])):
            tmp = mdir / fname.replace(".npy", ".tmp.npy")
            np.save(tmp, arr, allow_pickle=True)
            pairs.append((tmp, mdir / fname))
        for tmp, dst in pairs:
            os.replace(tmp, dst)

    def _identify(obj):
        # k is checked before the embedding takes a batcher slot
        k = int(obj.get("k", 1))
        if not 1 <= k <= 100:
            raise ValueError("k must be in [1, 100]")
        crops = _decode_audio_spec(obj, spec, num_eval)
        utt = _utt_embedding(batcher.submit(crops).result())
        _load_banks()
        # k on the JAX server's grid (it compiles one program per k),
        # trimmed back below
        k_eff = next(b for b in (1, 5, 10, 50, 100) if k <= b)
        with banks_lock.read():
            embeds, classes = banks["embeds"], banks["classes"]
            dev_bank = banks["device"]
            if len(embeds) == 0:
                raise ValueError("no speakers enrolled")
            if dev_bank is not None:
                s, i = dev_bank.identify(utt, k=k_eff)
                cand = [(str(dev_bank.name(int(ii))), float(ss))
                        for ss, ii in zip(s[0][:k], i[0][:k])]
            else:
                # nearest by distance, score 1 - d^2/2: on normalized
                # vectors the cosine the device bank ranks by
                d = np.linalg.norm(embeds - utt[None, :], axis=1)
                kk = min(k, len(d))
                part = np.argpartition(d, kk - 1)[:kk]
                order = part[np.argsort(d[part])]
                cand = [(str(classes[int(b)]), float(1.0 - d[b] ** 2 / 2.0))
                        for b in order]
        payload = {"speaker": cand[0][0], "score": cand[0][1]}
        if k > 1:
            payload["candidates"] = [{"speaker": nm, "score": sc}
                                     for nm, sc in cand]
        return payload

    def _enroll(obj):
        name = obj.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError("/enroll needs a 'name' string")
        crops = _decode_audio_spec(obj, spec, num_eval)
        utt = _utt_embedding(batcher.submit(crops).result())
        _load_banks()
        with banks_lock.write():
            new_idx = len(banks["embeds"])
            if banks["device"] is not None:
                # device first: if it fails, the host arrays are untouched
                # (add also writes the label into the shared classes dict)
                banks["device"].add(utt, [name])
            banks["classes"][new_idx] = name
            banks["embeds"] = np.concatenate([banks["embeds"],
                                              utt[None, :]])
            if (banks["device"] is None and device_bank_cfg == "auto"
                    and len(banks["embeds"]) >= AUTO_DEVICE_BANK_MIN_ROWS):
                # live growth crossed the threshold: promote now
                banks["device"] = _build_device_bank(banks["embeds"],
                                                     banks["classes"])
            _persist_banks()
        return {"speaker": name, "index": new_idx, "enrolled": new_idx + 1}

    def _unenroll(obj):
        _load_banks()
        with banks_lock.write():
            if "index" in obj:
                idx = int(obj["index"])
            else:
                nm = obj.get("name")
                hits = [i for i, v in banks["classes"].items() if v == nm]
                if len(hits) != 1:
                    raise ValueError(f"name {nm!r} matches {len(hits)} "
                                     "speakers; pass 'index'")
                idx = hits[0]
            n = len(banks["embeds"])
            if not 0 <= idx < n:
                raise ValueError(f"index {idx} not in bank of {n}")
            removed = banks["classes"][idx]
            last = n - 1
            if banks["device"] is not None:
                # the device bank's labels are banks["classes"] (the same
                # dict): remove() swaps the labels once for both
                if banks["device"]._labels is not banks["classes"]:
                    raise RuntimeError("device bank labels lost aliasing "
                                       "with the served classes")
                banks["device"].remove(idx)
            else:
                if idx != last:
                    banks["classes"][idx] = banks["classes"][last]
                banks["classes"].pop(last, None)
            if idx != last:
                banks["embeds"][idx] = banks["embeds"][last]
            banks["embeds"] = banks["embeds"][:last]
            _persist_banks()
        return {"speaker": str(removed), "enrolled": last}

    bank_routes = {"/identify": _identify, "/enroll": _enroll,
                   "/unenroll": _unenroll}

    class ServingHandler(BaseHTTPRequestHandler):
        server_version = "svtorch-serving/1.0"
        protocol_version = "HTTP/1.1"
        timeout = 30                      # idle keep-alive handlers exit
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            if serving.get("access_log"):
                super().log_message(fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok", "model": model_name,
                    "num_eval": num_eval, "samples": samples,
                    "batch_utts": batch_utts, "transport": transport,
                    "batches_run": batcher.batches_run,
                    "utts_served": batcher.utts_served,
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                return self._reply(400, {"error": f"bad JSON: {exc}"})
            try:
                if self.path == "/embed":
                    crops = _decode_audio_spec(obj, spec, num_eval)
                    utt = _utt_embedding(batcher.submit(crops).result())
                    return self._reply(200, {
                        "embedding": [float(x) for x in utt],
                        "dim": int(utt.shape[0])})
                if self.path == "/score":
                    futs = [batcher.submit(
                        _decode_audio_spec(obj[k], spec, num_eval))
                        for k in ("enroll", "test")]
                    e1, e2 = (f.result() for f in futs)
                    return self._reply(200, {"score": _pair_cosine(e1, e2)})
                if self.path in bank_routes:
                    return self._reply(200, bank_routes[self.path](obj))
                return self._reply(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, TypeError,
                    FileNotFoundError) as exc:
                return self._reply(400, {"error": str(exc)})

    ServingHandler.banks = banks          # for inspection and tests
    return ServingHandler, batcher


def warm_up(engine, batcher: DynamicBatcher) -> None:
    """Before traffic: a batch of silence at every size the batcher can
    send, ``batch_utts`` requests down to one, in its wire format
    through the engine's float path builds the kernels, picks each
    size's convolution plans and allocates the buffers (largest first,
    so the allocator's blocks fit the largest). An int8 engine calibrates
    on its first real batch instead: scales calibrated on silence
    describe silence, and speech would saturate them."""
    dtype = np.int16 if batcher.transport == "int16" else np.float32
    for n in range(batcher.batch_utts, 0, -1):
        engine.warm_up(np.zeros((n * batcher.num_eval, batcher.samples),
                                dtype))


def serve(hparams: Mapping, host: str = "0.0.0.0", port: int = 8008,
          weights: Optional[str] = None, device=None) -> None:
    """Blocking server entry; runs on CUDA unless ``device`` says else."""
    import signal

    from speakerverification_tpu_torch.inference import InferenceEngine

    engine = InferenceEngine(hparams, weights=weights, device=device)
    handler, batcher = make_serving_app(engine, hparams)
    warm_up(engine, batcher)
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = False          # drain handlers on shutdown
    print(f"[INFO] serving {(hparams.get('model') or {}).get('name', '?')} "
          f"on {host}:{port} (batch_utts={batcher.batch_utts}, "
          f"max_wait={batcher.max_wait * 1000:.0f}ms, "
          f"device={engine.device})")
    old_handlers = {}

    def _graceful(signum, frame):
        # first SIGTERM/SIGINT drains; a second one escalates
        for s, hnd in old_handlers.items():
            signal.signal(s, hnd)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[s] = signal.signal(s, _graceful)
        except ValueError:                # not the main thread
            pass
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        print("[INFO] serving stopped cleanly")
