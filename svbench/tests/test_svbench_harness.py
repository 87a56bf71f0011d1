"""CPU tests of the benchmark harness: its files found by name, a tiny
dry run's last line, the least-time arithmetic, the knee search, the
seeded inputs and the trace reduction.

    python -m pytest svbench/tests -q
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from svbench.drivers import serve
from svbench.harness import cells, compare, knee, roofline, seeded
from svbench.harness.core import FORBIDDEN
from svbench.harness.trace import gaps, merge
from svbench.reference.models import build_reference
from svbench.tests._tiny import EXTRACT, SERVE, TRAIN, run_tiny

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_file_is_found_by_name(workload):
    cell = cells.load_cell(workload)
    assert cell.config["name"] == [w for w in BENCH["workloads"]
                                   if w["name"] == workload][0]["config"]
    assert hasattr(cells.load_driver(cell.traffic["driver"]), "run")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert any("mfu" in m["name"] for m in cell.per_layer)
    assert any(m["name"].startswith("device.idle") for m in cell.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_is_found_and_reads_nothing_untraced(metric):
    read = cells.load_reader(metric)
    assert read({"trace": None}) is None


def test_configs_files_and_sources():
    for c in BENCH["configs"]:
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")
        # the reference builds from the file's sizes, with the program's
        # parameter count
        ref = build_reference(cfg["hparams"], with_loss=False)
        n = sum(p.numel() for p in ref.backbone.parameters())
        assert n == cfg["parameters"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell")


@pytest.mark.parametrize("workload,precision,switch", [
    (SERVE, "float32", "hparams"), (TRAIN, "float32", "hparams"),
    (EXTRACT, "int8", "reference_bits")])
def test_precision_and_its_control_come_from_the_configuration(
        workload, precision, switch):
    cell = cells.load_cell(workload)
    h = dict(cell.config["hparams"], **cell.traffic.get("hparams", {}))
    assert cells.precision(h) == precision
    assert switch in cells.control(cell, h)
    assert roofline.peak_for(cells.precision(h)) > 0


def test_unknown_arrivals_are_refused():
    cell = cells.load_cell(SERVE)
    server = types.SimpleNamespace(run=types.SimpleNamespace(cell=cell),
                                   crops=np.zeros((2, 1, 1)))
    w = serve.Server.window(server, 10.0, 1.0, np.random.default_rng(0))
    assert len(w.due) == 10
    cell.traffic["arrivals"] = "on_off"
    with pytest.raises(KeyError, match="on_off"):
        serve.Server.window(server, 10.0, 1.0, np.random.default_rng(0))


def test_run_without_a_card_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(cells.BENCH / "run.py"), "--workload", SERVE,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cells.ROOT)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("workload,e2e", [(SERVE, "serve_p95_ms"),
                                          (TRAIN, "train_crops_per_s")])
def test_tiny_dry_run_last_line(workload, e2e):
    run, line = run_tiny(workload)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", e2e}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checks"]) == set(run.cell.limits)


@pytest.mark.parametrize("batch,samples,n_fft,hop,n_mels,least_us", [
    # 160 crops of 2 s at 8 kHz: bytes-bound
    (160, 16000, 512, 80, 80, 6.128716),
    # 256 crops of 2 s at 16 kHz: bytes-bound
    (256, 32000, 512, 160, 80, 14.696693),
])
def test_mel_frontend_least_time(batch, samples, n_fft, hop, n_mels,
                                 least_us):
    ops, nbytes = roofline.mel_frontend_work(batch, samples, n_fft, hop,
                                             n_mels)
    frames = 1 + samples // hop
    per_frame = 2.5 * 512 * 9 + 3 * 257 + 2 * 257 * n_mels
    assert ops == batch * frames * per_frame
    assert nbytes == 4 * batch * (samples + frames * n_mels)
    got = roofline.mel_frontend_least_s(batch, samples, n_fft, hop, n_mels)
    assert got == pytest.approx(least_us * 1e-6, rel=1e-4)
    assert got == nbytes / roofline.PEAK_BYTES        # bytes set it


@pytest.mark.parametrize("m,k,n,bound", [
    # path C's hot shape, 160 crops x 1575 steps, K 1024, N 1024: the
    # fp32 activations and output set it
    (160 * 1575, 1024, 1024, "bytes"),
    (4096, 8192, 8192, "operations"),
    # a 160-row Dense: bytes-bound
    (160, 512, 512, "bytes"),
])
def test_int8_gemm_least_time(m, k, n, bound):
    ops = 2.0 * m * k * n
    nbytes = 4 * m * k + k * n + 4 * m * n
    got = roofline.int8_gemm_least_s(m, k, n)
    assert got == max(ops / roofline.PEAK_INT8, nbytes / roofline.PEAK_BYTES)
    want = (ops / roofline.PEAK_INT8 if bound == "operations"
            else nbytes / roofline.PEAK_BYTES)
    assert got == want


def _point(rate, capacity, base_ms=80.0, seconds=10.0):
    """An open-loop M/D/1-like curve: below capacity the latency stays
    flat; above it the backlog grows through the window."""
    if rate <= capacity:
        first = last = base_ms / (1 - 0.9 * rate / capacity)
        done = rate
    else:
        done = capacity
        first = base_ms * 4
        last = first + 1e3 * seconds * (rate - capacity) / capacity
    return knee.SweepPoint(rate, done, first, last)


def test_knee_on_a_synthetic_curve():
    pts = [_point(r, 146.0) for r in (60, 90, 120, 140, 146, 152, 170)]
    assert knee.find_knee(pts) == 146
    assert knee.find_knee(list(reversed(pts))) == 146
    # a rate that drops requests is not sustained, whatever its latency
    pts[2] = knee.SweepPoint(120, 110.0, 90.0, 90.0)
    assert knee.find_knee(pts) == 90
    with pytest.raises(ValueError):
        knee.find_knee([_point(200, 146.0)])


def test_quarter_medians():
    lat = np.concatenate([np.full(25, 10.0), np.full(50, 20.0),
                          np.full(25, 40.0)])
    assert knee.quarter_medians(lat) == (10.0, 40.0)


def test_fixed_gaps_share_their_values_across_seeds():
    a = seeded.fixed_gaps(np.random.default_rng(1), 117.0, 5967)
    b = seeded.fixed_gaps(np.random.default_rng(2 ** 40), 117.0, 5967)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert a.sum() == pytest.approx(5967 / 117.0, rel=2e-3)


def test_seeded_state_is_the_seeds():
    h = cells.load_cell(TRAIN).config["hparams"]
    h = dict(h, model=dict(h["model"], channels=[32, 32, 32, 32, 96]),
             nClasses=10)
    ref = build_reference(h, with_loss=True)
    s1, s2 = seeded.seeded_state(ref, 5), seeded.seeded_state(ref, 5)
    s3 = seeded.seeded_state(ref, 2 ** 33 + 5)     # past 32 bits
    assert set(s1) == set(ref.state_dict())
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(s1["loss.weight"], s3["loss.weight"])
    assert (s1["backbone.BatchNorm1d_0.BatchNorm_0.running_var"] >= 0.5).all()


def test_int16_audio_is_on_the_pcm_grid():
    a = seeded.int16_audio(np.random.default_rng(3), 24000, 8000)
    assert a.dtype == np.float32 and np.abs(a).max() <= 0.5
    assert np.array_equal(np.round(a * 32768.0), a * 32768.0)


def test_merge_and_gaps():
    m = merge([(0, 5), (3, 8), (10, 12), (11, 11.5)])
    assert m == [[0, 8], [10, 12]]
    assert gaps(m, -2, 15) == [(-2, 2), (8, 2), (12, 3)]
    assert gaps(m, 0, 8) == []


def test_leaf_gaps_and_moving_leaves():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 5e-9}
    gaps_ = compare.leaf_norm_gaps(got, ref)
    assert gaps_["a"] == pytest.approx(0.1)
    assert gaps_["c"] == pytest.approx(4e-9 / 1.0)    # over the median leaf
    assert compare.moving_leaves(ref) == ["a", "b"]
    assert compare.loss_gap([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    assert math.isinf(compare.loss_gap([float("nan")], [1.0]))


def test_forbidden_names_compare_whole_top_level_names():
    assert "speakerverification_tpu" in FORBIDDEN
    assert "speakerverification_tpu_torch".partition(".")[0] not in FORBIDDEN
