"""CPU tests of the readers of the program's spans: synthetic span lists
with known answers, and the program's own spans of a profiled CPU train
step read through ``harness/spans.py``.

    python -m pytest svbench/tests/test_svbench_spans.py -q
"""

from __future__ import annotations

import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svbench.harness import cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["batcher.queue_wait_ms.serve", "batcher.turnaround_ms.serve",
                "engine.h2d_ms.serve", "engine.h2d_ms.extract",
                "loader.wait_ms.extract", "train.host_ms.train",
                "train.forward_ms.train", "train.backward_ms.train",
                "train.optimizer_ms.train"]
_ids = itertools.count(1)
MS = 1_000_000          # ns in a ms


def sp(name, start_ms, end_ms, trace=None, parent=None, device_ms=None,
       **attrs):
    return SimpleNamespace(name=name, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), span_id=next(_ids),
                           parent=parent, trace=trace, attrs=attrs,
                           device_ms=device_ms)


def read(metric, spans):
    return cells.load_reader(metric)({"trace": object(), "spans": spans})


def test_the_nine_readers_are_in_the_benchmark():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["better"] == "lower" and len(m["workloads"]) == 1
        assert m["workloads"][0].split("-")[1] == name.rsplit(".", 1)[1]


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_trace_or_no_spans_reads_nothing(metric):
    read_ = cells.load_reader(metric)
    assert read_({"trace": None}) is None
    assert read_({"trace": object(), "spans": []}) is None
    # spans of another layer only
    assert read(metric, [sp("other", 0, 1)]) is None


def test_queue_wait_is_the_95th_percentile():
    waits = np.arange(1, 101, dtype=float)        # 1..100 ms
    spans = [sp("batcher.queued", 10.0, 10.0 + w, trace=i)
             for i, w in enumerate(waits)]
    assert read("batcher.queue_wait_ms.serve", spans) == pytest.approx(
        float(np.percentile(waits, 95)))


def test_turnaround_leaves_out_blocked_heads():
    spans = []
    # batch 0: the first, no batch before it
    spans += [sp("batcher.batch", 0, 60, trace=0, blocked=True),
              sp("engine.forward", 5, 50, trace=0),
              sp("batcher.copy_back", 50, 55, trace=0)]
    # batch 1 waited for: 55 -> 62, 7 ms
    spans += [sp("batcher.batch", 56, 120, trace=1, blocked=False),
              sp("engine.forward", 62, 110, trace=1),
              sp("batcher.copy_back", 110, 112, trace=1)]
    # batch 2 found the queue empty: its 100-ms gap is the traffic's
    spans += [sp("batcher.batch", 200, 260, trace=2, blocked=True),
              sp("engine.forward", 212, 250, trace=2),
              sp("batcher.copy_back", 250, 251, trace=2)]
    # batch 3 waited for, two devices' forwards: the first counts,
    # 251 -> 254, 3 ms
    spans += [sp("batcher.batch", 251.5, 300, trace=3, blocked=False),
              sp("engine.forward", 256, 290, trace=3),
              sp("engine.forward", 254, 290, trace=3),
              sp("batcher.copy_back", 290, 292, trace=3)]
    # the extract cell's forwards carry no batch: left out
    spans += [sp("engine.forward", 400, 500)]
    assert read("batcher.turnaround_ms.serve", spans) == pytest.approx(5.0)
    only_blocked = [s for s in spans if s.trace in (0, 2)]
    assert read("batcher.turnaround_ms.serve", only_blocked) is None


@pytest.mark.parametrize("metric", ["engine.h2d_ms.serve",
                                    "engine.h2d_ms.extract"])
def test_h2d_is_the_mean_copy(metric):
    # the host waits behind the stream's earlier work: the events' time
    # is the copy's, the spans' 70 and 85 ms on the host are not
    spans = [sp("engine.h2d", 0, 70, device_ms=1.5),
             sp("engine.h2d", 100, 185, device_ms=2.5),
             sp("engine.forward", 185, 240, device_ms=50.0)]
    assert read(metric, spans) == pytest.approx(2.0)
    # copies without events (the CPU) read nothing
    assert read(metric, [sp("engine.h2d", 0, 1.5)]) is None


def test_loader_wait_leaves_out_each_pass_start():
    spans = [sp("loader.wait", 0, 400, batch=0),
             sp("loader.wait", 500, 560, batch=1),
             sp("loader.wait", 700, 780, batch=2),
             sp("loader.wait", 900, 1300, batch=0),
             sp("loader.wait", 1400, 1430, batch=1)]
    assert read("loader.wait_ms.extract", spans) == pytest.approx(
        (60 + 80 + 30) / 3)
    assert read("loader.wait_ms.extract", spans[:1]) is None


def _steps(n, micro=1, device=(30.0, 50.0, 5.0)):
    each = [None if d is None else d / micro for d in device[:2]]
    spans = []
    for k in range(n):
        st = sp("train.step", 100 * k, 100 * k + 80)
        spans.append(st)
        for _ in range(micro):
            spans += [sp("train.forward", 100 * k + 1, 100 * k + 20,
                         parent=st.span_id, device_ms=each[0]),
                      sp("train.backward", 100 * k + 20, 100 * k + 60,
                         parent=st.span_id, device_ms=each[1])]
        spans.append(sp("train.optimizer", 100 * k + 60, 100 * k + 79,
                        parent=st.span_id, device_ms=device[2]))
    return spans


@pytest.mark.parametrize("micro", [1, 2])
def test_train_phases_are_stream_time_a_step(micro):
    spans = _steps(4, micro)
    # a phase outside any recorded step is left out
    spans.append(sp("train.forward", 1000, 1001, parent=-1, device_ms=99.0))
    assert read("train.host_ms.train", spans) == pytest.approx(80.0)
    assert read("train.forward_ms.train", spans) == pytest.approx(30.0)
    assert read("train.backward_ms.train", spans) == pytest.approx(50.0)
    assert read("train.optimizer_ms.train", spans) == pytest.approx(5.0)


def test_train_phases_without_events_read_nothing():
    spans = _steps(2, device=(None, None, None))
    assert read("train.host_ms.train", spans) == pytest.approx(80.0)
    for phase in ("forward", "backward", "optimizer"):
        assert read(f"train.{phase}_ms.train", spans) is None


def test_the_program_spans_of_a_profiled_step_are_read():
    from svbench.tests._tiny import tiny_cell, TRAIN
    from speakerverification_tpu_torch.builder import (
        encoder_from_hparams,
        optimizer_from_hparams,
    )
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    from speakerverification_tpu_torch.utils import tracing
    torch.set_num_threads(2)
    h = dict(tiny_cell(TRAIN).config["hparams"])
    h["audio_spec"] = dict(h["audio_spec"], sentence_len=0.25)
    model = encoder_from_hparams(h, with_loss=True)
    tx = optimizer_from_hparams(h)
    state = create_train_state(model, tx, 1)
    step = make_train_step(model, tx)
    wave = 0.1 * torch.randn(4, 2, 4000)
    label = torch.arange(4)
    tracing.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(2):
                state, _ = step(state, wave, label, 1e-3)
        r = {"trace": object()}
        host = cells.load_reader("train.host_ms.train")(r)
        assert host is not None and host > 0
        # on the CPU the phases have no CUDA events
        assert cells.load_reader("train.forward_ms.train")(r) is None
        assert len([s for s in tracing.spans()
                    if s.name == "train.step"]) == 2
    finally:
        tracing.clear()
