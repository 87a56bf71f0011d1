"""The program's spans (``utils/tracing.py``): off without a profiler,
and where the work happens under one.

This file imports torch only (no JAX), so its ``cuda``-marked test also
runs on the GPU host:

    python -m pytest --noconftest tests/test_torch_tracing.py -q

Without a profiler ``span`` returns one shared no-op and nothing is
recorded. Under ``torch.profiler`` the batcher, the loader and the train
step record their spans with the parents, trace ids and attributes the
module's docstrings name; every span opened with ``with`` has the
profiler's ``record_function`` range of its name within 1 ms of its own
ends (both read ``time.time_ns``'s clock; the two stamps are taken a few
microseconds apart), and on the CPU no span has a device time. On the
card, ``engine.forward`` holds the host-side launch of its forward's mel
kernel, and its CUDA events' time agrees with events around the call to
5 %.
"""

import threading
import time
import wave as wavefile

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from speakerverification_tpu_torch.builder import (
    encoder_from_hparams,
    optimizer_from_hparams,
)
from speakerverification_tpu_torch.evaluation.evaluator import (
    extract_embeddings,
)
from speakerverification_tpu_torch.serving import DynamicBatcher
from speakerverification_tpu_torch.training.state import create_train_state
from speakerverification_tpu_torch.training.train_step import make_train_step
from speakerverification_tpu_torch.utils import tracing

SR = 16000
TRAIN_H = {
    "seed": 3,
    "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
              "nOut": 32, "channels": [16, 16, 16, 16, 48]},
    "features": "melspectrogram",
    "audio_spec": {"sample_rate": SR, "channels": 1, "sentence_len": 0.25,
                   "win_len": 0.025, "hop_len": 0.01},
    "n_mels": 40, "fmin": 20.0, "fmax": 7600.0, "nClasses": 8,
    "criterion": {"name": "AAmSoftmax", "margin": 0.2, "scale": 30},
    "optimizer": {"name": "AdaBelief", "weight_decay": 2e-05},
    "lr": 0.001,
}


@pytest.fixture(autouse=True)
def _empty():
    torch.set_num_threads(2)
    tracing.clear()
    yield
    tracing.clear()


def _profiler():
    """The CPU profiler, with every thread's ranges (the batcher's
    worker is not the thread that starts it)."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _ranges(prof) -> dict:
    """name -> [(start_ns, end_ns)] of the profiler's host events."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _assert_ranges(prof, spans, tol_ns=1_000_000):
    ranges = _ranges(prof)
    for s in spans:
        assert any(abs(a - s.start_ns) <= tol_ns and abs(b - s.end_ns)
                   <= tol_ns for a, b in ranges.get(s.name, ())), s


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _batcher_round_trip(requests=5, batch_utts=2):
    """Requests submitted from their own threads at once to a batcher
    over a CPU embed function; returns their ids' order of submit times
    (before, after) and the answers."""
    def embed(waves):
        time.sleep(0.002)
        return torch.as_tensor(waves[:, :4], dtype=torch.float32)

    b = DynamicBatcher(embed, batch_utts=batch_utts, num_eval=2, samples=8,
                       max_wait_ms=20.0)
    crops = [np.full((2, 8), i / 10, np.float32) for i in range(requests)]
    stamps, answers = {}, {}

    def client(i):
        t0 = time.time_ns()
        fut = b.submit(crops[i])
        stamps[i] = (t0, time.time_ns())
        answers[i] = fut.result(timeout=30)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    b.close()
    for i in range(requests):
        np.testing.assert_array_equal(answers[i], crops[i][:, :4])
    return stamps


def _wavs(tmp_path, n=5, seconds=0.5):
    rng = np.random.default_rng(0)
    files = []
    for i in range(n):
        path = tmp_path / f"u{i}.wav"
        pcm = (rng.standard_normal(int(seconds * SR)) * 3000).astype("<i2")
        with wavefile.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        files.append(str(path))
    return files


def _embed_rows(waves):
    return torch.as_tensor(np.asarray(waves)[:, :3])


def _train_step(accum_steps=1):
    model = encoder_from_hparams(TRAIN_H, with_loss=True)
    tx = optimizer_from_hparams(TRAIN_H)
    state = create_train_state(model, tx, 3)
    step = make_train_step(model, tx, accum_steps=accum_steps)
    gen = torch.Generator().manual_seed(5)
    wave = 0.1 * torch.randn(4, 2, int(0.25 * SR), generator=gen)
    label = torch.arange(4)
    return state, step, wave, label


def test_off_nothing_is_recorded(tmp_path):
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", device=True, k=1)
    assert a is b
    with a as s:
        assert s.id is None
    tracing.record("z", 0, 1)
    _batcher_round_trip()
    extract_embeddings(_embed_rows, _wavs(tmp_path, 3), TRAIN_H["audio_spec"],
                       num_eval=2, batch_size=2, num_workers=1)
    state, step, wave, label = _train_step()
    step(state, wave, label, 1e-3)
    assert tracing.spans() == []


def test_the_flag_is_read_on_every_call(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    with tracing.span("outer", trace=7, a=1, b=2):
        with tracing.span("inner") as inner:
            tracing.record("stamped", 10, 20)
        tracing.record("elsewhere", 30, 40, parent=99, trace=3)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)
    assert tracing.span("after") is tracing.span("again")
    got = _by_name(tracing.spans())
    (o,), (i,), (st,), (el,) = (got[k] for k in ("outer", "inner", "stamped",
                                                   "elsewhere"))
    assert o.attrs == {"a": 1, "b": 2} and o.parent is None and o.trace == 7
    assert i.parent == o.span_id and i.trace == 7
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert (st.parent, st.trace, st.start_ns, st.end_ns) == (
        inner.id, 7, 10, 20)
    assert (el.parent, el.trace) == (99, 3)
    assert "after" not in got
    assert all(s.device_ms is None for s in tracing.spans())
    tracing.clear()
    assert tracing.spans() == []


def test_batcher_spans():
    with _profiler() as prof:
        stamps = _batcher_round_trip(requests=5, batch_utts=2)
    spans = tracing.spans()
    got = _by_name(spans)
    batches = {b.span_id: b for b in got["batcher.batch"]}
    queued = got["batcher.queued"]
    # one per request, each with its own request id, each in a batch
    assert sorted(q.trace for q in queued) == list(range(5))
    assert all(q.parent in batches for q in queued)
    for b in batches.values():
        mine = [q for q in queued if q.parent == b.span_id]
        assert len(mine) >= 1
        assert isinstance(b.attrs["blocked"], bool)
        for q in mine:
            assert b.start_ns <= q.end_ns <= b.end_ns
    assert sorted(b.trace for b in batches.values()) == list(
        range(len(batches)))
    # each request's wait starts inside a submit call
    for q in queued:
        assert any(lo <= q.start_ns <= hi for lo, hi in stamps.values())
        assert q.start_ns <= q.end_ns
    # the four children, once each, inside their batch
    for name in ("batcher.fill", "batcher.assemble", "batcher.copy_back",
                 "batcher.reply"):
        kids = got[name]
        assert sorted(k.parent for k in kids) == sorted(batches)
        for k in kids:
            b = batches[k.parent]
            assert b.start_ns <= k.start_ns <= k.end_ns <= b.end_ns
            assert k.trace == b.trace
    # each assembly names the requests and rows its batch carries
    for a in got["batcher.assemble"]:
        mine = [q for q in queued if q.parent == a.parent]
        assert a.attrs == {"utts": len(mine), "rows": 2 * len(mine)}
    assert all(s.device_ms is None for s in spans)
    _assert_ranges(prof, [s for s in spans if s.name != "batcher.queued"])


def test_extract_records_one_loader_wait_per_batch(tmp_path):
    files = _wavs(tmp_path, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        emb = extract_embeddings(_embed_rows, files, TRAIN_H["audio_spec"],
                                 num_eval=2, batch_size=2, num_workers=1)
    assert emb.shape == (5, 2, 3)
    spans = tracing.spans()
    waits = [s for s in spans if s.name == "loader.wait"]
    assert [w.attrs for w in waits] == [{"batch": 0}, {"batch": 1},
                                        {"batch": 2}]
    assert all(s.device_ms is None for s in spans)
    _assert_ranges(prof, spans)


@pytest.mark.parametrize("accum_steps,micro", [(1, 1), (2, 2)])
def test_train_step_phases(accum_steps, micro):
    state, step, wave, label = _train_step(accum_steps)
    step(state, wave, label, 1e-3)          # outside: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, out = step(state, wave, label, 1e-3)
    assert torch.isfinite(out["loss"])
    spans = tracing.spans()
    got = _by_name(spans)
    (st,) = got["train.step"]
    counts = {k: len(got.get(k, ())) for k in
              ("train.forward", "train.backward", "train.optimizer")}
    assert counts == {"train.forward": micro, "train.backward": micro,
                      "train.optimizer": 1}
    phases = [s for s in spans if s.name in counts]
    for s in phases:
        assert s.parent == st.span_id
        assert st.start_ns <= s.start_ns <= s.end_ns <= st.end_ns
        assert s.device_ms is None
    order = [s.name for s in sorted(phases, key=lambda s: s.start_ns)]
    assert order == ["train.forward", "train.backward"] * micro + [
        "train.optimizer"]
    _assert_ranges(prof, spans)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launch_times(prof, kernel: str) -> list:
    """Host start times of the runtime or driver calls that launched
    each device event whose name holds ``kernel``."""
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type() == cuda
               and kernel in e.name()]
    host = {}
    for e in events:
        if e.device_type() != cuda and e.correlation_id():
            host.setdefault(e.correlation_id(), []).append(e)
    out = []
    for k in kernels:
        calls = host.get(k.correlation_id()) or host.get(
            k.linked_correlation_id(), [])
        assert calls, (f"no host call for {k.name()} (correlation "
                       f"{k.correlation_id()})")
        out.append(min(c.start_ns() for c in calls))
    return out


@pytest.mark.cuda
def test_forward_span_holds_its_mel_launch_and_device_time(cuda):
    from speakerverification_tpu_torch.inference import make_eval_embed_fn
    h = dict(TRAIN_H, model={"name": "ECAPA_TDNN",
                             "feature_type": "melspectrogram", "nOut": 192},
             audio_spec=dict(TRAIN_H["audio_spec"], sentence_len=2.0),
             n_mels=80)
    model = encoder_from_hparams(h).to(cuda)
    embed = make_eval_embed_fn(model)
    wave = 0.1 * torch.randn(160, 2 * SR, device=cuda)
    for _ in range(3):
        embed(wave)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        embed(wave)
        end.record()
        torch.cuda.synchronize()
    (fwd,) = [s for s in tracing.spans() if s.name == "engine.forward"]
    launches = _launch_times(prof, "mel_kernel")
    assert len(launches) == 1
    assert fwd.start_ns <= launches[0] <= fwd.end_ns, (fwd, launches)
    around = start.elapsed_time(end)
    assert fwd.device_ms is not None
    assert abs(fwd.device_ms - around) <= 0.05 * around, (fwd.device_ms,
                                                          around)
    _assert_ranges(prof, [fwd])
