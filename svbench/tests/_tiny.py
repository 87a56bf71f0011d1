"""Tiny cells for the CPU tests: the benchmark's own cells with their
widths and loads cut down, run in-process on the CPU by the cells' own
drivers (the chip check of ``run.py`` is what they skip)."""

from __future__ import annotations

import contextlib
import copy
import io
import json

import torch

from svbench.harness import cells, core
from svbench.run import _metrics

SERVE = "raw3_ecapa-serve-poisson"
TRAIN = "ecapa_tdnn-train-b256"
EXTRACT = "raw3_ecapa-extract-int8"


def tiny_cell(workload: str) -> cells.Cell:
    """``workload`` with ECAPA-TDNN at 64 channels and a load that a CPU
    run holds in seconds."""
    cell = cells.load_cell(workload)
    cell = copy.deepcopy(cell)
    base = cells.load_cell(TRAIN).config
    cfg = copy.deepcopy(base)
    cfg["control"] = copy.deepcopy(cell.config["control"])
    cfg["hparams"]["model"]["channels"] = [64, 64, 64, 64, 192]
    cfg["hparams"]["nClasses"] = 40
    cell.config = cfg
    if cell.traffic["driver"] == "extract":
        cfg["hparams"]["num_eval"] = 3
        cell.traffic.update(files=24, trials_per_file=2, warm_files=8,
                            check_trials=12)
        cell.traffic["hparams"] = dict(cell.traffic["hparams"],
                                       eval_batch_size=4,
                                       dataloader_options={"num_workers": 2})
        cell.limits = {"score_gap_max": 1e-4}
    elif cell.traffic["driver"] == "serve":
        cfg["hparams"]["num_eval"] = 3
        cell.traffic.update(rate_per_s=6.0, batch_utts=2, pool_utts=4,
                            check_requests=3, drain_s=30.0)
        cell.limits = {"embed_gap_max": 1e-4}
    else:
        cell.traffic.update(speakers_per_batch=4, distinct_batches=4,
                            warm_steps=1)
        cell.limits = {"loss_gap_first": 1e-4, "grad_norm_gap": 1e-2,
                       "grad_norm_gap_median": 1e-3,
                       "change_norm_gap": 2e-2, "window_loss_gap": 1e-4,
                       "window_grad_norm_gap_median": 1e-3,
                       "window_change_norm_gap": 2e-2}
    return cell


def run_tiny(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
             **kw) -> tuple[core.Run, dict]:
    """One CPU run of the tiny ``workload``; returns the run and the
    parsed last line it printed."""
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    run = core.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                   device="cpu", **kw)
    cells.load_driver(cell.traffic["driver"]).run(run)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        core.emit(run.result(_metrics(cell, run, False),
                             {"platform": "cpu", "count": 0}))
    return run, json.loads(out.getvalue().strip().splitlines()[-1])
