"""The default stack's train step at full width, port against the JAX
package: ``Raw3_ECAPA`` (nOut 512) + ARmSoftmax over 13,103 classes +
AdaBelief, fp32, on 0.5 s crops of 4 speakers × 2 (CPU).

Each port step starts from the JAX step's incoming state (a checkpoint
the JAX package writes and the port restores whole), 3 steps. The first
step also runs through the port in float64 (``Float64Port``): the exact
reference both fp32 steps are measured from.

In training mode the raw branch is ill-conditioned in fp32: its
log(|sinc| + 1e-6) features feed BatchNorms that normalize by the
batch's statistics, so a 1e-7 change of the wave moves RawNet3's output
by 7e-3 (measured). The JAX step on the CPU sits 3.6e-4 (loss) and 4.9e-3
(statistics) from the float64 reference, the port's fp32 step 5e-6 and
1.4e-4. So the port is held to the reference tightly and to JAX within
JAX's own distance from it (CHANGES.md has every measurement):

* port vs float64: loss 1e-4 relative, statistics 1e-3 of each tensor's
  largest value, the update's cosine ≥ 0.995 (all parameters but those
  whose gradient is zero by construction, ``RAW3_ZERO_GRAD``);
* port at least as close to the reference as JAX, on all three;
* port vs JAX, every step: loss 2e-3 relative, statistics 2e-2,
  update cosine ≥ 0.85.
"""

import torch

from test_torch_port_train_helpers import raw3_steps


def check(rows) -> None:
    first = rows[0]
    ref = first["loss_ref"]
    assert abs(first["loss_port"] - ref) <= 1e-4 * abs(ref)
    assert abs(first["loss_port"] - ref) <= abs(first["loss_jax"] - ref)
    assert first["stats_port_ref"] <= 1e-3
    assert first["stats_port_ref"] <= first["stats_jax_ref"]
    assert first["cos_port_ref"] >= 0.995
    assert first["cos_port_ref"] >= first["cos_jax_ref"]
    for i, row in enumerate(rows):
        assert abs(row["loss_port"] - row["loss_jax"]) <= \
            2e-3 * abs(row["loss_jax"]), (i, row)
        assert row["stats_port_jax"] <= 2e-2, (i, row)
        assert row["cos_port_jax"] >= 0.85, (i, row)


def test_raw3_ecapa_full_width_fp32_steps(tmp_path):
    torch.set_num_threads(2)
    check(raw3_steps(tmp_path, accum_steps=1))
