"""The default stack's train step at full width with ``accumulate_steps:
2``, port against the JAX package (fp32, CPU): two microbatches of 2
speakers × 2 crops, each from the step's incoming statistics, the mean
gradient and the averaged statistics. The measures and tolerances are
``test_torch_port_train_raw3.py``'s.

One step: the JAX package's accumulating step scans its microbatches,
and at the test suite's XLA optimization level 0 a scan over the
full-width model runs 65 s a step on the CPU (its 3-step runs are in
``test_torch_port_train_step.py``, on the small ECAPA)."""

import torch

from test_torch_port_train_raw3 import check
from test_torch_port_train_helpers import raw3_steps


def test_raw3_ecapa_full_width_fp32_accum2_steps(tmp_path):
    torch.set_num_threads(2)
    check(raw3_steps(tmp_path, accum_steps=2, n_steps=1))
