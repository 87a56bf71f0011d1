"""Each fault the cells can have, planted under a tiny run on the CPU
(the harness's look for a chip skipped, the rest of a run driven as the
benchmark drives it), comes out as ``correct`` false.

    python -m pytest svbench/tests/test_svbench_faults.py -q
"""

from __future__ import annotations

import pytest

from svbench.tests._tiny import EXTRACT, SERVE, TRAIN, run_tiny


@pytest.mark.parametrize("workload,number", [(SERVE, "embed_gap_max"),
                                             (EXTRACT, "score_gap_max")])
def test_answer_altered_where_it_is_produced(workload, number):
    run, line = run_tiny(workload, fault="answer")
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "change_norm_gap"),     # the state returned unchanged
    ("half", "grad_norm_gap_median"),     # half the batch left out
])
def test_training_fault(fault, number):
    run, line = run_tiny(TRAIN, fault=fault)
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] > c["limit"]


def test_unchanged_state_reads_one():
    run, _ = run_tiny(TRAIN, fault="unchanged")
    assert run.readings["numbers"]["change_norm_gap"] == pytest.approx(1.0)
