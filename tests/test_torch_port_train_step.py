"""The whole train step, port against the JAX package, on a small
ECAPA_TDNN + AAmSoftmax + Adam (CPU).

The same config, weights and batches go through the JAX step (jitted)
and the port's. Each port step starts from the JAX step's incoming
state, restored whole from a checkpoint the JAX package writes, so that
every step is compared on its own (3 steps; fp32 at ``accum_steps`` 1
and 2, and bf16).

Tolerances (measured in CHANGES.md): fp32 loss 1e-5 relative, batch
statistics 1e-5 of each tensor's largest value; parameters: the step's
update within 3e-2 of JAX's in norm (relative; cosine ≥ 0.9995), and
every element within Adam's bound of 2·lr per step. Adam divides the first
moment by the root of the second, so an element whose gradient is near
0 moves by up to ±lr on its rounding noise, in either package (JAX
against itself shows it under 1e-7 input noise): one such element of
the 39,000 moves the update's norm by 1e-2 (measured: 2.5e-7 to 1.0e-2
over the six steps). The attentive pooling's
attention bias has an exactly zero gradient (a softmax over time ignores
a per-channel shift), so both packages move it on noise alone: it is
held to |p| ≤ lr per step.
bf16: loss 2e-2 relative, the update's cosine to JAX's ≥ 0.9 (Adam's
first step is the sign of the bf16 gradient).
"""

import numpy as np
import pytest
import torch

from test_torch_port_train_helpers import (
    Pair,
    batches,
    flat,
    rel_errors,
    update_cosines,
)

LR = 1e-3
ZERO_GRAD = ("AttentiveStatisticsPooling_0/Conv1d_0/Conv_0/bias",)
H = {"seed": 0, "audio_spec": {"sample_rate": 8000, "sentence_len": 0.5},
     "features": "melspectrogram", "n_mels": 80,
     "model": {"name": "ECAPA_TDNN", "nOut": 16,
               "channels": [32, 32, 32, 32, 96], "attention_channels": 8,
               "se_channels": 8, "res2net_scale": 4},
     "criterion": {"name": "AAmSoftmax", "margin": 0.2, "scale": 30},
     "nClasses": 6, "lr": LR, "optimizer": {"name": "adam"}}


@pytest.mark.parametrize("accum", [1, 2])
def test_small_ecapa_fp32_steps_match_jax(accum, tmp_path):
    torch.set_num_threads(2)
    data = batches(np.random.default_rng(0), 3, 4, 2, 4000, 6)
    pair = Pair(H, data[0], accum_steps=accum)
    before = flat(pair.jstate.params)
    for i, (jm, tm, js, (tp, ts)) in enumerate(pair.steps(data, LR,
                                                          tmp_path)):
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(jl - tl) <= 1e-5 * abs(jl), (i, jl, tl)
        assert float(jm["prec1"]) == pytest.approx(float(tm["prec1"]))
        stats = rel_errors(ts, flat(js.batch_stats))
        assert max(stats.values()) <= 1e-5, (i, max(stats.items(),
                                                     key=lambda kv: kv[1]))
        ref = flat(js.params)
        keep = [k for k in ref if not "/".join(k).endswith(ZERO_GRAD)]
        for key in ref:
            if key in keep:
                assert np.max(np.abs(tp[key] - ref[key])) <= 2.02 * LR
            else:
                assert np.max(np.abs(tp[key])) <= 1.01 * LR * (i + 1)
        got = np.concatenate([(tp[k] - before[k]).ravel() for k in keep])
        want = np.concatenate([(ref[k] - before[k]).ravel() for k in keep])
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        cos, _ = update_cosines(tp, before, ref, ZERO_GRAD)
        print(f"step {i}: update error {err:.3e}, cosine {cos:.8f}")
        assert err <= 3e-2 and cos >= 0.9995, (i, err, cos)
        before = ref
    assert pair.tstate.step == 3


def test_small_ecapa_bf16_steps_match_jax(tmp_path):
    torch.set_num_threads(2)
    data = batches(np.random.default_rng(1), 3, 4, 2, 4000, 6)
    pair = Pair({**H, "mixedprec": True}, data[0])
    before = flat(pair.jstate.params)
    for i, (jm, tm, js, (tp, ts)) in enumerate(pair.steps(data, LR,
                                                          tmp_path)):
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(jl - tl) <= 2e-2 * abs(jl), (i, jl, tl)
        after = flat(js.params)
        cos, _ = update_cosines(tp, before, after, ZERO_GRAD)
        assert cos >= 0.9, (i, cos)
        before = after
    # the masters stay fp32, and so do the statistics
    assert all(p.dtype == torch.float32 for p in pair.tstate.params.values())
    assert all(s.dtype == torch.float32
               for s in pair.tstate.batch_stats.values())


@pytest.mark.parametrize("device,inside", [("cpu", False), ("cuda", True)])
def test_timed_conv_plans_only_on_cuda(device, inside):
    """The step times cuDNN's convolution plans on a CUDA device only,
    and puts the flag back afterwards, also when the step raises."""
    from speakerverification_tpu_torch.training.train_step import (
        timed_conv_plans,
    )
    cudnn = torch.backends.cudnn
    was = cudnn.benchmark
    with timed_conv_plans(torch.device(device)):
        assert cudnn.benchmark is (inside or was)
    assert cudnn.benchmark is was
    with pytest.raises(RuntimeError, match="inside"):
        with timed_conv_plans(torch.device(device)):
            raise RuntimeError("inside")
    assert cudnn.benchmark is was
