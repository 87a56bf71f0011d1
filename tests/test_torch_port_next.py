"""The raw-wave encoders RawNeXt and ResNeXt, and the standalone RawNet3
with every option, port against the JAX package (CPU).

* RawNeXt and ResNeXt at the small sizes of ``tests/test_more_encoders.py``
  (levels all 1, channels 32–64) on 2 waves of 8,000 samples (wrapped to
  59,049): eval, and train mode (the ×9-normalized codes and the
  BatchNorm statistics the forward updates); a deeper RawNeXt (levels
  1, 1, 1, 2, 2, 1: the nested ``Tree_*`` scopes and the roots over the
  children handed down) and one without the up path and gate.
* The traps alone: one transposed conv (flax does not flip the kernel:
  the bridge does), ``GateModule`` on three branches (the interleaved
  view feeds the MLP, the weights scale the branches whole).
* RawNet3 at C 16 on 2 waves of 8,000 samples: each option alone
  (``out_bn``, ``log_sinc`` off, ``norm_sinc`` ``mean_std`` and
  ``none``, ``encoder_type`` ECA, ``summed`` and ``context`` off,
  ``sinc_stride`` 5) in eval, and two combinations in train mode.
* At the builders' defaults (full width) each model's tree equals a
  ``jax.eval_shape`` of the JAX init and its int8 table (the wide,
  ungrouped, stride-1 1-D convs and the Denses that pass JAX's floors)
  equals JAX's.

The weights are the port's, redrawn from a seed and carried to JAX by
``params_to_jax``; the JAX outputs are computed once, in module fixtures.
Tolerances, of the largest output: in eval (fp32) 3e-5 for the NeXt
models (sums in other orders over 20-odd layers; measured 1.04e-5 for
the deep RawNeXt) and 1e-4 for RawNet3, whose log(|sinc| + 1e-6)
amplifies the error of near-zero filter outputs (measured 6e-5; the
bar of ``test_torch_port_models.py``), the transposed conv and the
gate 2e-6. Train mode is ill-conditioned in fp32 at a batch of 2: the
batch statistics of features that barely vary between the two waves
flip signs (JAX's fp32 output sits up to 0.53 of its largest value from
its float64 run), so the NeXt models' train mode holds the port's
float64 run to JAX's float64 run (``jax.enable_x64``), output and every
statistic tensor, within 1e-8. RawNet3 pins its sinc front to fp32 in
both packages, so neither has an exact float64 run (JAX's fp32 train
output sits 2e-4 to 0.12 of its largest value from its float64 run);
the port's fp32 run is held to JAX's float64 run at most twice as far
as JAX's own fp32 run (floor 1e-5; measured 0.5–0.9 of JAX's distance).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu.models import next as JN
from speakerverification_tpu.models import rawnet3 as J3
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.models import next as TN
from speakerverification_tpu_torch.models import rawnet3 as T3
from speakerverification_tpu_torch.quant import calibrate_act_scales
from speakerverification_tpu_torch.weights import (
    params_from_jax,
    params_to_jax,
)

from test_torch_port_helpers import (
    close,
    jax_tree_and_quant_keys,
    port_tree,
    port_variables,
    t,
)

SMALL = dict(nOut=16, levels=(1, 1, 1, 1, 1, 1),
             channels=(32, 32, 32, 32, 64, 64))
CASES = {
    "RawNeXt": (lambda: JN.RawNeXt(**SMALL), lambda: TN.RawNeXt(**SMALL)),
    "ResNeXt": (lambda: JN.ResNeXt(**SMALL), lambda: TN.ResNeXt(**SMALL)),
    "RawNeXt deep": (
        lambda: JN.RawNeXt(**{**SMALL, "levels": (1, 1, 1, 2, 2, 1)}),
        lambda: TN.RawNeXt(**{**SMALL, "levels": (1, 1, 1, 2, 2, 1)})),
    "ResNeXt no up path, no gate": (
        lambda: JN.ResNeXt(**SMALL, up_path=False, gate=False),
        lambda: TN.ResNeXt(**SMALL, up_path=False, gate=False)),
}

RAW3 = dict(nOut=24, C=16, model_scale=8)
RAW3_EVAL = {"default": {}, "out_bn": {"out_bn": True},
             "no log": {"log_sinc": False},
             "mean_std": {"norm_sinc": "mean_std"},
             "no norm": {"norm_sinc": "none"}, "ECA": {"encoder_type": "ECA"},
             "not summed": {"summed": False}, "no context": {"context": False},
             "stride 5": {"sinc_stride": 5}}
RAW3_TRAIN = {"ECA out_bn mean_std": {"encoder_type": "ECA", "out_bn": True,
                                      "norm_sinc": "mean_std"},
              "no context, not summed, no log": {
                  "context": False, "summed": False, "log_sinc": False}}


def waves(n: int, samples: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, samples))
            ).astype(np.float32)


def _run_jax(jm, v, x, train: bool):
    """JAX's eval output (fp32), or its train output and statistics in
    float64 (``jax.enable_x64``)."""
    if not train:
        return np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))), None
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        y, mut = jax.jit(lambda v_, x_: jm.apply(
            v_, x_, train=True, mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64))
        return np.asarray(y), {k: np.asarray(a) for k, a in
                               flatten_dict(mut["batch_stats"]).items()}


@pytest.fixture(scope="module")
def outputs():
    """Per case: the port module, and JAX's eval output and (for the
    NeXt models and RAW3_TRAIN) train output and statistics."""
    torch.set_num_threads(2)
    out = {}
    x = waves(2, 8000, seed=1)
    for name, (make_j, make_t) in CASES.items():
        jm, tm = make_j(), make_t()
        v = port_variables(tm, seed=1)
        out[name] = (tm, x, _run_jax(jm, v, x, False)[0],
                     _run_jax(jm, v, x, True))
    for name, opts in {**RAW3_EVAL, **RAW3_TRAIN}.items():
        jm, tm = J3.RawNet3(**RAW3, **opts), T3.RawNet3(**RAW3, **opts)
        v = port_variables(tm, seed=2)
        train = None
        if name in RAW3_TRAIN:
            y32, mut = jax.jit(lambda v_, x_: jm.apply(
                v_, x_, train=True, mutable=["batch_stats"]))(
                v, jnp.asarray(x))
            stats32 = {k: np.asarray(a) for k, a in
                       flatten_dict(mut["batch_stats"]).items()}
            train = (_run_jax(jm, v, x, True), (np.asarray(y32), stats32))
        out["RawNet3 " + name] = (tm, x, _run_jax(jm, v, x, False)[0], train)
    return out


def _check(outputs, name: str, train: bool, rel: float) -> None:
    tm0, x, ev, tr = outputs[name]
    if not train:
        tm0.eval()
        with torch.no_grad():
            close(tm0(t(x)).numpy(), ev, rel, f"{name} eval")
        return
    tm = copy.deepcopy(tm0).double().train()
    with torch.no_grad():
        got = tm(t(x).double()).numpy()
    close(got, tr[0], 1e-8, f"{name} train (float64)")
    stats = flatten_dict(params_to_jax(tm.state_dict())[1])
    assert set(stats) == set(tr[1])
    for k, ref in tr[1].items():
        close(stats[k], ref, 1e-8, f"{name} {'/'.join(k)} (float64)")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_next_models_match_jax(outputs, name, train):
    _check(outputs, name, train, rel=3e-5)
    if train:
        # training codes have norm 9
        tm = copy.deepcopy(outputs[name][0]).train()
        with torch.no_grad():
            code = tm(t(outputs[name][1]))
        np.testing.assert_allclose(code.norm(dim=1).numpy(), 9.0, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RAW3_EVAL))
def test_rawnet3_options_eval(outputs, name):
    _check(outputs, "RawNet3 " + name, False, 1e-4)


def _dist(a, b, ref) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / max(np.max(np.abs(ref)), 1e-6))


@pytest.mark.parametrize("name", sorted(RAW3_TRAIN))
def test_rawnet3_options_train(outputs, name):
    """RawNet3 pins its front to fp32 in both packages, so no float64 run
    is exact; the port's fp32 train output and statistics are held to
    JAX's float64 run at most twice as far as JAX's own fp32 run is
    (floor 1e-5 of the largest value)."""
    tm0, x, _, ((y64, s64), (y32, s32)) = outputs["RawNet3 " + name]
    tm = copy.deepcopy(tm0).train()
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert np.all(np.isfinite(got))
    bar = max(2 * _dist(y32, y64, y64), 1e-5)
    assert _dist(got, y64, y64) <= bar, (name, _dist(got, y64, y64), bar)
    stats = flatten_dict(params_to_jax(tm.state_dict())[1])
    assert set(stats) == set(s64)
    for k, ref in s64.items():
        bar = max(2 * _dist(s32[k], ref, ref), 1e-5)
        assert _dist(stats[k], ref, ref) <= bar, (name, k)


def test_rawnet3_rejects_unknown_options():
    with pytest.raises(ValueError, match="norm_sinc"):
        T3.RawNet3(norm_sinc="std")
    with pytest.raises(ValueError, match="encoder_type"):
        T3.RawNet3(encoder_type="SAP")


def test_conv_transpose_is_not_flipped_in_flax():
    """k 3, stride 3, VALID: JAX computes y[3i+j] = x[i]·K[2−j]; the
    bridge flips the taps into torch's ``[in, out, k]`` weight."""
    import flax.linen as fnn
    x = np.random.default_rng(3).normal(0, 1, (2, 7, 5)).astype(np.float32)
    jm = fnn.ConvTranspose(6, (3,), (3,), padding="VALID")
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": jax.tree.map(lambda a: np.asarray(a) + 0.1,
                                v["params"])}
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = torch.nn.ConvTranspose1d(5, 6, 3, 3)
    state = params_from_jax({"ConvTranspose_0": v["params"]})
    tm.load_state_dict({k.split(".", 1)[1]: a for k, a in state.items()})
    with torch.no_grad():
        got = tm(t(x.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    assert got.shape == (2, 21, 6)
    close(got, ref, 2e-6, "ConvTranspose")
    # and back: the flax kernel, unflipped
    back, _ = params_to_jax({f"ConvTranspose_0.{k}": a
                             for k, a in tm.state_dict().items()})
    np.testing.assert_array_equal(back["ConvTranspose_0"]["kernel"],
                                  v["params"]["kernel"])


def test_gate_module_interleaved_view():
    """The pooled ``[B, 3·C]`` read as ``[B, C, 3]`` feeds the MLP; the
    weights of slot i scale branch i whole."""
    rng = np.random.default_rng(4)
    branches = [rng.normal(size=(2, 10, 16)).astype(np.float32)
                for _ in range(3)]
    jm = JN.GateModule(channels=16, bottleneck=5, nb_input=3)
    tm = TN.GateModule(16, 5, 3)
    v = port_variables(tm, seed=4)
    ref = np.asarray(jax.jit(jm.apply)(v, [jnp.asarray(b) for b in branches]))
    with torch.no_grad():
        got = tm([t(b.transpose(0, 2, 1)) for b in branches]).numpy()
    close(got.transpose(0, 2, 1), ref, 2e-6, "GateModule")


# the builders at their defaults: (JAX builder, int8 table size)
DEFAULTS = {"RawNeXt": (JN.build_rawnext, 28),
            "ResNeXt": (JN.build_resnext, 10),
            "RawNet3": (J3.build_rawnet3, 11)}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_builder_defaults_tree_and_int8_table(name):
    torch.set_num_threads(2)
    x = waves(1, 8000, seed=5)
    build, n_int8 = DEFAULTS[name]
    jm = build(feature_type="raw")
    tm = TB.build_model(name, feature_type="raw")
    tree, keys = jax_tree_and_quant_keys(jm, jnp.asarray(x))
    assert port_tree(tm) == tree
    got = set(calibrate_act_scales(tm, t(x)))
    assert got == keys
    assert len(got) == n_int8, sorted(got)


def _bridge_models():
    from speakerverification_tpu_torch.models import image_encoders as TI
    from speakerverification_tpu_torch.models.mixed import build_mixed_model
    return {
        "RawNeXt deep": TN.RawNeXt(**{**SMALL, "levels": (1, 1, 1, 2, 2, 1)}),
        "DPN (grouped)": TI.DPN(nOut=16, k_sec=(1, 1, 1, 1),
                                inc_sec=(4, 8, 8, 16), k_r=32, groups=8),
        "EfficientNet (depthwise)": TI.EfficientNet(nOut=16, width_coeff=1.0,
                                                    depth_coeff=0.3),
        "Mixed (branches_*)": build_mixed_model(
            ["RawNet3", "ECAPA_TDNN"], nOut=48, nOuts=[32, 16],
            branch_options=[{"C": 16}, {"channels": [16, 16, 16, 16, 48],
                                        "attention_channels": 4,
                                        "res2net_scale": 4,
                                        "se_channels": 4}], n_mels=24),
    }


@pytest.mark.parametrize("name", ["RawNeXt deep", "DPN (grouped)",
                                  "EfficientNet (depthwise)",
                                  "Mixed (branches_*)"])
def test_weight_bridge_round_trip_and_refusals(name):
    """``params_to_jax`` then ``params_from_jax`` gives the state back bit
    for bit (transposed convs flipped twice, grouped and depthwise
    kernels, the nested ``Tree_*`` and ``branches_*`` scopes); a leaf
    missing or left over raises."""
    tm = _bridge_models()[name]
    params, stats = params_to_jax(tm.state_dict())
    back = params_from_jax(params, stats, like=tm)
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v.float() if v.is_floating_point()
                           else v), k
    flat = flatten_dict(params)
    key = max(flat, key=lambda k: ("ConvTranspose" in "/".join(k), k))
    missing = dict(flat)
    del missing[key]
    from flax.traverse_util import unflatten_dict
    with pytest.raises(KeyError):
        params_from_jax(unflatten_dict(missing), stats, like=tm)
    extra = {**flat, key[:-1] + ("Dense_9", "kernel"): np.zeros((2, 2))}
    with pytest.raises(KeyError):
        params_from_jax(unflatten_dict(extra), stats, like=tm)


def test_waves_wrap_to_3_to_the_10_per_example():
    """Each wave tiles itself along time (the reference's tiling repeats
    along the batch, a bug the JAX package does not keep)."""
    x = torch.arange(2 * 7, dtype=torch.float32).reshape(2, 7)
    got = TN.wrap_to_fixed(x)
    assert got.shape == (2, TN.FIXED_SAMPLES)
    for b in range(2):
        assert torch.equal(got[b], x[b].repeat(TN.FIXED_SAMPLES // 7 + 1)
                           [:TN.FIXED_SAMPLES])
    wave = waves(2, 5000, seed=6)
    ref = np.asarray(jnp.tile(jnp.asarray(wave), (1, JN.FIXED_SAMPLES
                                                  // 5000 + 1))
                     [:, :JN.FIXED_SAMPLES])
    np.testing.assert_array_equal(TN.wrap_to_fixed(t(wave)).numpy(), ref)
