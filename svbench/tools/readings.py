#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers that
decide ``correct``, of the program, of its control or of a planted
fault, each seed in a process of its own through ``svbench/run.py`` (as
the benchmark runs it: no state of one seed's run reaches the next).

    python3 svbench/tools/readings.py --workload ecapa_tdnn-train-b256 \
        --seconds 2 --seeds 11 12 13 [--control 1 | --fault half] \
        [--stderr-dir DIR]

Prints one JSON line per seed: ``{"seed", "mode", "numbers",
"correct", "rc"}``. Each run goes through the cell's own driver at the
cell's own sizes and load, with a short window; ``numbers`` are all the
numbers its check worked out, compared or not (``None`` where the run
printed no result). With ``--stderr-dir`` each run's standard error is
kept there as ``<mode>_<seed>.err``."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "svbench" / "run.py"


def one(workload: str, seed: int, seconds: float, control: int,
        fault, timeout: float = 1500, keep=None) -> dict:
    """One run of ``run.py`` for ``seed``; its numbers and verdict (its
    standard error written to the path ``keep`` where given)."""
    cmd = [sys.executable, str(RUN), "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", "0",
           "--control", str(control)]
    if fault:
        cmd += ["--fault", fault]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    if keep is not None:
        Path(keep).write_text(proc.stderr)
    numbers = None
    for line in proc.stderr.splitlines():
        if line.startswith("[numbers] "):
            numbers = json.loads(line[len("[numbers] "):])
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    correct = json.loads(lines[-1])["correct"] if lines else None
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
    return {"numbers": numbers, "correct": correct, "rc": proc.returncode}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--stderr-dir", type=Path, default=None)
    args = p.parse_args(argv)
    mode = ("control" if args.control else
            f"fault:{args.fault}" if args.fault else "program")
    if args.stderr_dir is not None:
        args.stderr_dir.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        keep = (None if args.stderr_dir is None else
                args.stderr_dir / f"{mode.replace(':', '_')}_{seed}.err")
        row = one(args.workload, seed, args.seconds, args.control,
                  args.fault, keep=keep)
        print(json.dumps({"seed": seed, "mode": mode, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
