"""Training-mode BatchNorm, flax's initializers, and the kernels' modes
(CPU).

* ``models.layers.batch_norm`` in training mode against flax's
  ``nn.BatchNorm(momentum=0.9)``: the output, and the running mean and
  variance after 3 updates, to 1e-6 — over ``[B, C, T]`` and over the
  pooled ``[B, C]`` after attentive pooling with B = 8, whose batch
  variance torch's own update would take unbiased (1/(B-1) off).
* eval mode is ``nn.BatchNorm1d`` itself, bit for bit.
* ``weights.init_weights_`` draws from flax's distributions: the
  per-tensor std of a fresh port model within 5 % of a fresh flax init's.
* K2 (the Res2Net cascade) is eval-only: a ``Res2NetBlock`` in training
  mode never reaches its wrapper.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu import builder as JB
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.models import layers as tlayers
from speakerverification_tpu_torch.models.layers import (
    Res2NetBlock,
    batch_norm,
    bn_module,
)
from speakerverification_tpu_torch.ops import res2net_cascade as trc
from speakerverification_tpu_torch.weights import init_weights_, params_to_jax


@pytest.mark.parametrize("offset,tol", [(0.5, 1e-6), (3.0, 1e-4)],
                         ids=["offset 0.5", "offset 3"])
@pytest.mark.parametrize("shape", [(4, 6, 33), (8, 12)],
                         ids=["BCT", "pooled B8"])
def test_train_mode_batch_norm_matches_flax(shape, offset, tol):
    """Both compute the batch variance as E[x²] − E[x]² in fp32; with a
    mean six times the spread (offset 3) that difference cancels ~5 bits
    in both packages alike, so the two sum orders agree to 1e-4 there
    (3.6e-5 measured) and to 1e-6 at offset 0.5."""
    rng = np.random.default_rng(0)
    C = shape[1]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5, axis=-1)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    bn = bn_module(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    for step in range(3):
        x = (offset + rng.normal(0, 0.5, shape)).astype(np.float32)
        xj = x if len(shape) == 2 else x.transpose(0, 2, 1)
        ref, upd = flax_bn.apply(variables, jnp.asarray(xj),
                                 mutable=["batch_stats"])
        variables = {**variables, "batch_stats": upd["batch_stats"]}
        got = batch_norm(bn, torch.from_numpy(x)).detach().numpy()
        ref = np.asarray(ref)
        ref = ref if len(shape) == 2 else ref.transpose(0, 2, 1)
        assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))
    for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        want = np.asarray(variables["batch_stats"][name])
        assert np.max(np.abs(buf.numpy() - want)) <= tol * np.max(
            np.abs(want)), name


def test_train_mode_batch_norm_uses_the_biased_variance():
    """torch's own update would take the unbiased batch variance."""
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
    ours, torchs = bn_module(5), bn_module(5)
    batch_norm(ours.train(), x)
    torchs.train()(x)
    biased = x.var(0, unbiased=False)
    assert torch.allclose(ours.running_var, 0.9 + 0.1 * biased, rtol=1e-6)
    assert not torch.allclose(ours.running_var, torchs.running_var,
                              rtol=1e-3)


def test_train_mode_batch_norm_bf16_computes_in_fp32():
    """bf16 activations and parameters: statistics from the fp32 values,
    one rounding of the fp32 result, fp32 running statistics."""
    g = torch.Generator().manual_seed(1)
    x = (2 + torch.randn(4, 6, 20, generator=g)).bfloat16()
    bn = bn_module(6).train()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(6, generator=g))
    # parameters cast to bf16 as the train step casts them
    with torch.no_grad():
        w16, b16 = bn.weight.bfloat16(), bn.bias.bfloat16()
    y = torch.func.functional_call(
        tlayers.BatchNorm1d(6).train(),
        {"BatchNorm_0.weight": w16, "BatchNorm_0.bias": b16},
        (x,), strict=False)
    assert y.dtype == torch.bfloat16
    xf = x.float()
    m, v = xf.mean((0, 2)), (xf * xf).mean((0, 2)) - xf.mean((0, 2)) ** 2
    want = ((xf - m[:, None]) * (torch.rsqrt(v + 1e-5) * w16.float())[:, None]
            + b16.float()[:, None]).bfloat16()
    assert torch.equal(y, want)


def test_eval_mode_batch_norm_is_torch_bit_for_bit():
    g = torch.Generator().manual_seed(2)
    bn = bn_module(7)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(7, generator=g))
        bn.running_var.copy_(torch.rand(7, generator=g) + 0.5)
        bn.weight.copy_(torch.randn(7, generator=g))
    x = torch.randn(3, 7, 11, generator=g)
    bn.eval()
    assert torch.equal(batch_norm(bn, x), bn(x))


def _stds(tree) -> dict:
    return {"/".join(k): float(np.std(np.asarray(v)))
            for k, v in flatten_dict(tree).items() if np.asarray(v).size > 1}


def _check_init(h: dict, same_means=()) -> None:
    """Per-tensor std of a fresh full-width stack ``h`` within 5 % of
    flax's (constant tensors exactly); the tensors ``same_means`` keep
    flax's constant values."""
    jm = JB.encoder_from_hparams(h, with_loss=True, num_devices=1)
    spec = h["audio_spec"]
    x = jnp.zeros((2, 2, int(spec["sentence_len"] * spec["sample_rate"])))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), x,
                                 jnp.zeros(2, jnp.int32))
    tm = TB.encoder_from_hparams(h, with_loss=True)
    init_weights_(tm, torch.Generator().manual_seed(3))
    params, stats = params_to_jax(tm.state_dict())
    for col, got in (("params", params), ("batch_stats", stats)):
        want = _stds(variables[col])
        got = _stds(got)
        assert set(got) == set(want)
        for k, s in want.items():
            if s == 0.0:
                assert got[k] == 0.0, k
            elif "low_hz" in k or "band_hz" in k:
                assert got[k] == pytest.approx(s, rel=1e-5), k
            else:
                assert got[k] == pytest.approx(s, rel=0.05), (k, got[k], s)
    means = {"/".join(k): float(np.mean(np.asarray(v)))
             for k, v in flatten_dict(variables["params"]).items()}
    got_means = {"/".join(k): float(np.mean(v))
                 for k, v in flatten_dict(params).items()}
    for k in same_means:
        assert got_means[k] == means[k], k


def test_init_distributions_match_flax():
    """Per-tensor std of a fresh full-width Raw3_ECAPA + ARmSoftmax
    within 5 % of flax's (constant tensors exactly)."""
    h = {"audio_spec": {"sample_rate": 8000, "sentence_len": 0.5},
         "features": "raw", "model": {"name": "Raw3_ECAPA",
                                      "feature_type": "raw", "nOut": 512},
         "criterion": {"name": "ARmSoftmax"}, "nClasses": 1000}
    _check_init(h, ("backbone/raw_branch/inorm_scale",
                    "backbone/ecapa/input_norm_scale",
                    "backbone/raw_branch/Bottle2neckRaw_0/AFMS_0/alpha"))


def test_init_distributions_match_flax_rawnet2_family():
    """The same for Raw_ECAPA_sinc_gru + AAmSoftmaxAP: the GRU's input
    kernels (lecun_normal) and recurrent ones (orthogonal), the sample
    LayerNorm's 1/0 and AngularProto's constants 10 and -5."""
    torch.set_num_threads(2)
    h = {"audio_spec": {"sample_rate": 16000, "sentence_len": 0.2},
         "features": "raw", "model": {"name": "Raw_ECAPA_sinc_gru",
                                      "feature_type": "raw", "nOut": 512},
         "criterion": {"name": "AAmSoftmaxAP"}, "nClasses": 1000}
    _check_init(h, ("backbone/raw_branch/SampleLayerNorm_0/gamma",
                    "backbone/raw_branch/SampleLayerNorm_0/beta",
                    "loss/AngularProto_0/w", "loss/AngularProto_0/b"))


def test_res2net_block_in_training_never_reaches_the_cascade(monkeypatch):
    calls = []
    monkeypatch.setattr(tlayers, "res2net_cascade",
                        lambda *a, **k: calls.append(1))
    blk = Res2NetBlock(32, scale=4, kernel_size=3, dilation=2,
                       backend="pallas")
    x = torch.randn(2, 32, 20)
    blk.train()
    blk(x).sum().backward()
    assert calls == []
    blk.eval()
    with torch.no_grad():
        blk(x)
    assert calls == [1]            # eval with 'pallas' goes to the kernel
    assert trc.launches == 0
