"""On the card: each cell's control (the configuration's own
lower-precision path in the program's place) comes out as not correct,
on three seeds, at the cell's own size and load, while the program on
the same seeds comes out correct; each seed runs in a process of its own
(``svbench/tools/readings.py``), as the benchmark runs it. Skips without
a card.

    python -m pytest svbench/tests/test_svbench_control.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from svbench.harness.cells import BENCH, ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (3_000_000_011, 3_000_000_012, 3_000_000_013)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _readings(workload: str, *flags: str) -> list:
    proc = subprocess.run(
        [sys.executable, str(BENCH / "tools" / "readings.py"),
         "--workload", workload, "--seconds", "3", "--seeds",
         *map(str, SEEDS), *flags],
        capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    rows = _readings(workload, "--control", "1")
    assert len(rows) == len(SEEDS)
    assert not any(r["correct"] for r in rows), rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(card, workload):
    rows = _readings(workload)
    assert len(rows) == len(SEEDS)
    assert all(r["correct"] for r in rows), rows
