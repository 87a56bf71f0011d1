"""CPU tests of ``batcher.rows_per_batch.serve``'s reader: synthetic
spans with a known mean, spans without the attribute, and the program's
own spans of a batcher run under the CPU profiler.

    python -m pytest svbench/tests/test_svbench_rows_per_batch.py -q
"""

from __future__ import annotations

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from svbench.harness import cells

METRIC = "batcher.rows_per_batch.serve"


def sp(name, **attrs):
    return SimpleNamespace(name=name, start_ns=0, end_ns=1, span_id=0,
                           parent=None, trace=None, attrs=attrs,
                           device_ms=None)


def read(spans):
    return cells.load_reader(METRIC)({"trace": object(), "spans": spans})


def test_the_reader_is_in_the_benchmark():
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}[METRIC]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        "program_span", "rows", "lower", "serve_p95_ms")
    assert m["workloads"] == ["raw3_ecapa-serve-poisson"]


def test_the_mean_rows_of_the_assemblies():
    spans = [sp("batcher.assemble", utts=u, rows=20 * u) for u in (1, 2, 6)]
    spans += [sp("batcher.copy_back"), sp("batcher.batch", blocked=True)]
    assert read(spans) == pytest.approx(60.0)


@pytest.mark.parametrize("spans", [
    [],
    [sp("batcher.assemble"), sp("batcher.assemble")],   # the parent's
    [sp("batcher.copy_back", rows=160)],
])
def test_no_rows_reads_nothing(spans):
    assert read(spans) is None
    assert cells.load_reader(METRIC)({"trace": None}) is None


def test_the_program_spans_of_a_batcher_run_are_read():
    from speakerverification_tpu_torch.serving import DynamicBatcher
    from speakerverification_tpu_torch.utils import tracing

    def embed(waves):
        return torch.as_tensor(waves[:, :4], dtype=torch.float32)

    tracing.clear()
    b = DynamicBatcher(embed, batch_utts=3, num_eval=2, samples=8,
                       max_wait_ms=20.0)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)):
            futs = []
            threads = [threading.Thread(target=lambda i=i: futs.append(
                b.submit(np.full((2, 8), i, np.float32)))) for i in range(5)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            for f in list(futs):
                f.result(timeout=30)
            got = cells.load_reader(METRIC)({"trace": object()})
        assert got == pytest.approx(b.rows_run / b.batches_run)
        assert b.rows_run == 2 * b.utts_served == 10
    finally:
        b.close()
        tracing.clear()
