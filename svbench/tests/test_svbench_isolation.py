"""Nothing the benchmark runs loads the JAX stack or the JAX package,
and its reference imports nothing of the program.

A subprocess imports the harness, the drivers, the reference, every
metric reader, the tools and the program modules the drivers call, then
lists the loaded modules whose top-level name (before the first dot) is
one of ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``speakerverification_tpu``, compared whole: the program's own name
begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from svbench.harness.cells import BENCH, ROOT
from svbench.harness.core import FORBIDDEN

PROGRAM = "speakerverification_tpu_torch"

_PROBE = r"""
import json, pathlib, sys
sys.path.insert(0, {root!r})
from svbench.harness import cells, core
import svbench.run, svbench.tools.sweep, svbench.tools.readings
import svbench.reference.models
bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
for w in bench["workloads"]:
    cell = cells.load_cell(w["name"])
    cells.load_driver(cell.traffic["driver"])
for m in bench["per_layer"]:
    cells.load_reader(m["name"])
import speakerverification_tpu_torch.inference
import speakerverification_tpu_torch.serving
import speakerverification_tpu_torch.builder
import speakerverification_tpu_torch.training.state
import speakerverification_tpu_torch.training.train_step
import speakerverification_tpu_torch.ops.mel_frontend
print(json.dumps(core.forbidden_loaded()))
"""


def test_no_jax_in_a_run():
    proc = subprocess.run([sys.executable, "-c",
                           _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_the_jax_stack():
    for path in BENCH.rglob("*.py"):
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.partition(".")[0] != PROGRAM, (path, name)
            assert not name.startswith("svbench.") or \
                name.startswith("svbench.reference"), (path, name)
