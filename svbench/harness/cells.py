"""A cell's files, found by the names in ``BENCHMARK.json``.

- ``configs[].file``: the configuration (the program's hyperparameters
  as run, its source, what was reduced or assumed, and for each
  precision it runs in, the control one step below it);
- ``svbench/traffic/<traffic>.json``: the traffic mix, a data file read
  by the general driver it names (``svbench/drivers/<driver>.py``);
- ``svbench/cells/<workload>.json``: the cell's limits on the numbers
  that decide ``correct``, with the readings they were set from;
- ``svbench/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable

__all__ = ["ROOT", "BENCH", "Cell", "load_cell", "load_reader", "load_driver",
           "precision", "control"]

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``; ``KeyError`` when the benchmark has
    no such cell, ``FileNotFoundError`` when one of its files is
    missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "cells" / f"{workload}.json")
                        .read_text())["limits"]
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def _load_file(path: Path, attr: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "svbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def load_reader(metric: str) -> Callable:
    """``read(readings) -> float | None`` of ``svbench/metrics/<metric>.py``."""
    return _load_file(BENCH / "metrics" / f"{metric}.py", "read")


def load_driver(name: str):
    """The driver module ``svbench/drivers/<name>.py``."""
    return importlib.import_module(f"svbench.drivers.{name}")


def precision(h: dict) -> str:
    """The precision a run's hyperparameters state: ``int8`` where they
    quantize (``quant: int8``), else ``float32``."""
    return "int8" if h.get("quant") == "int8" else "float32"


def control(cell: Cell, h: dict) -> dict:
    """The configuration's control for the precision ``h`` states: the
    program's own lower-precision switch (``hparams``) or the reference
    in fewer bits (``reference_bits``)."""
    return cell.config["control"][precision(h)]
