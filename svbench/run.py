#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port on the
card it starts on.

    python3 svbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It loads the cell's files by the names in ``BENCHMARK.json``, sets up
(seeded weights and inputs, the program's own build and warm-up),
measures for ``--seconds``, checks the window's answers against the
plain reference in ``svbench/reference/``, and prints one JSON line as
its last line on standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``. Everything else
goes to standard error. ``--control 1`` runs the configuration's
lower-precision control in the program's place and ``--fault <name>``
plants a fault; the benchmark's own runs use neither (the tests in
``svbench/tests/`` do).

Exit codes: 0 a result was printed; 2 no such cell or a file of it is
missing; 3 no CUDA device or too few; 4 the program cannot be imported;
5 the JAX stack or the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def _metrics(cell, run, trace: bool) -> dict:
    from svbench.harness.cells import load_reader
    out = {}
    if not trace:
        for m in cell.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" \
                else run.e2e[m["name"]]
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    readings = dict(run.readings, trace=run.trace_summary)
    for m in cell.per_layer:
        value = load_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")

    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from svbench.harness import cells, core
    started = core.process_start()
    try:
        cell = cells.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        core.log(f"[svbench] {exc}")
        return 2

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        core.log(f"[svbench] {cell.name} needs {cell.chips} CUDA device(s); "
                 f"available: {torch.cuda.is_available()}, count "
                 f"{torch.cuda.device_count()}")
        return 3
    try:
        import speakerverification_tpu_torch  # noqa: F401
    except ImportError as exc:
        core.log(f"[svbench] the program cannot be imported: {exc}")
        return 4
    core.log(f"[svbench] {cell.name} seed {args.seed} on "
             f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}; SM clock, power, temperature, "
             f"power limit: {core.card_state()}")

    run = core.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), control=bool(args.control),
                   fault=args.fault, started=started)
    cells.load_driver(cell.traffic["driver"]).run(run)
    core.log(f"[svbench] card after the run: {core.card_state()}")

    if "numbers" in run.readings:
        core.log(f"[numbers] {json.dumps(run.readings['numbers'])}")
    found = core.forbidden_loaded()
    if found:
        core.log(f"[svbench] forbidden modules loaded: {found}")
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace_summary is not None:
        device["busy_s"] = run.trace_summary.busy_s
        device["window_s"] = run.trace_summary.window_s
    core.emit(run.result(_metrics(cell, run, bool(args.trace)), device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
