"""The mel-image encoders (EfficientNet v1/v2, RepVGG with its deploy
fold, SCNet, DPN), port against the JAX package (CPU).

Every model at the small sizes of ``tests/test_more_encoders.py``, eval
and train mode (the output and the BatchNorm statistics the forward
updates; EfficientNet's dropout at rate 0 on both sides), on mel-like
features from a seeded numpy draw; EfficientNet on an even (64 × 40) and
an odd (63 × 37) image, since flax's stride-2 'SAME' pads an even size
0 before and 1 after. The blocks that hold the traps alone: MBConv at
stride 2 on even and odd maps, SCBottleneck on a map whose sides are not
multiples of 4 (its pooled gate is upsampled with half-pixel centres).
The weights are the port's, redrawn from a seed and carried to JAX by
``params_to_jax`` (one jitted JAX apply a case; the JAX outputs are
computed once, in a module fixture).

At the builders' defaults (full width), each model's tree equals a
``jax.eval_shape`` of the JAX init (names and shapes, both collections),
and its int8 table (the layers JAX's rule quantizes in one forward: only
Dense layers here, 2-D convs never) equals JAX's.

Tolerances: eval 1e-5 of the largest output (fp32 sums in other
orders), train mode 1e-4 of the largest output and of each statistic
tensor's largest value (measured below 2e-5), blocks 2e-5; the RepVGG
fold 1e-6 of each leaf's largest value, and the deploy model's eval
output 1e-5 from the train layout's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu.models import image_encoders as JI
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.models import image_encoders as TI
from speakerverification_tpu_torch.quant import calibrate_act_scales
from speakerverification_tpu_torch.weights import params_to_jax

from test_torch_port_helpers import (
    close,
    jax_tree_and_quant_keys,
    port_tree,
    port_variables,
    t,
)


def feats(shape, seed: int) -> np.ndarray:
    """Positive mel-like features ``[B, T, F]``."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(0.5, 0.2, shape)) ** 2).astype(np.float32)


EVEN, ODD = (2, 64, 40), (2, 63, 37)

# name: (JAX module, port module, input shapes)
CASES = {
    "EfficientNetV2": (
        lambda: JI.EfficientNetV2(nOut=16, cfgs=((1, 8, 1, 1, 0),
                                                 (4, 16, 1, 2, 1))),
        lambda: TI.EfficientNetV2(nOut=16, cfgs=((1, 8, 1, 1, 0),
                                                 (4, 16, 1, 2, 1))),
        (EVEN,)),
    "EfficientNet": (
        lambda: JI.EfficientNet(nOut=16, width_coeff=1.0, depth_coeff=0.3,
                                dropout_rate=0.0),
        lambda: TI.EfficientNet(nOut=16, width_coeff=1.0, depth_coeff=0.3,
                                dropout_rate=0.0),
        (EVEN, ODD)),
    "EfficientNet flatten": (
        lambda: JI.EfficientNet(nOut=16, width_coeff=1.0, depth_coeff=0.3,
                                dropout_rate=0.0, aggregate="flatten",
                                log_input=False),
        lambda: TI.EfficientNet(nOut=16, width_coeff=1.0, depth_coeff=0.3,
                                dropout_rate=0.0, aggregate="flatten",
                                log_input=False),
        (ODD,)),
    "RepVGG": (
        lambda: JI.RepVGG(nOut=16, num_blocks=(1, 1, 1, 1),
                          width=(0.25, 0.25, 0.25, 0.5)),
        lambda: TI.RepVGG(nOut=16, num_blocks=(1, 1, 1, 1),
                          width=(0.25, 0.25, 0.25, 0.5)),
        (EVEN,)),
    "SCNet": (lambda: JI.SCNet(nOut=16, layers=(1, 1, 1, 1)),
              lambda: TI.SCNet(nOut=16, layers=(1, 1, 1, 1)), (EVEN,)),
    "SCNet undilated": (
        lambda: JI.SCNet(nOut=16, layers=(1, 2, 1, 1), dilated=False),
        lambda: TI.SCNet(nOut=16, layers=(1, 2, 1, 1), dilated=False),
        (ODD,)),
    "DPN": (lambda: JI.DPN(nOut=16, k_sec=(1, 1, 1, 1),
                           inc_sec=(4, 8, 8, 16), k_r=32, groups=8),
            lambda: TI.DPN(nOut=16, k_sec=(1, 1, 1, 1),
                           inc_sec=(4, 8, 8, 16), k_r=32, groups=8),
            (EVEN,)),
}


def _stats(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def outputs():
    """Per case: the port module (eval, weights as carried), its JAX
    variables, and JAX's eval output, train output and updated
    statistics on each input."""
    torch.set_num_threads(2)
    out = {}
    for name, (make_j, make_t, shapes) in CASES.items():
        jm, tm = make_j(), make_t()
        v = port_variables(tm, seed=1)
        runs = []
        for i, shape in enumerate(shapes):
            x = feats(shape, seed=10 + i)
            ev = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
            tr, mut = jax.jit(lambda v_, x_: jm.apply(
                v_, x_, train=True, mutable=["batch_stats"]))(
                v, jnp.asarray(x))
            runs.append((x, ev, np.asarray(tr), _stats(mut["batch_stats"])))
        out[name] = (tm, v, runs)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_matches_jax(outputs, name):
    tm, _, runs = outputs[name]
    tm.eval()
    for x, ev, _, _ in runs:
        with torch.no_grad():
            got = tm(t(x)).numpy()
        close(got, ev, 1e-5, f"{name} eval {x.shape}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_mode_matches_jax(outputs, name):
    """Train-mode BatchNorm: the output and the running statistics."""
    import copy
    tm0, _, runs = outputs[name]
    for x, _, tr, stats in runs:
        tm = copy.deepcopy(tm0).train()
        with torch.no_grad():
            got = tm(t(x)).numpy()
        close(got, tr, 1e-4, f"{name} train {x.shape}")
        _, got_stats = params_to_jax(tm.state_dict())
        got_stats = {k: v for k, v in flatten_dict(got_stats).items()}
        assert set(got_stats) == set(stats)
        for k in stats:
            close(got_stats[k], stats[k], 1e-4, f"{name} {k}")


@pytest.mark.parametrize("shape", [(2, 10, 12, 8), (2, 9, 11, 8)],
                         ids=["even", "odd"])
def test_mbconv_same_padding_at_stride_2(shape):
    """flax's 'SAME' at stride 2: 0 before, 1 after on an even side (and
    1, 1 on an odd one); torch's symmetric ``padding`` cannot say it."""
    x = np.random.default_rng(2).normal(0, 1, shape).astype(np.float32)
    jm = JI.MBConv(16, 6, 5, 2, bn_eps=1e-3)
    tm = TI.MBConv(8, 16, 6, 5, 2, bn_eps=1e-3)
    v = port_variables(tm, seed=2)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape[1:3] == (-(-shape[1] // 2), -(-shape[2] // 2))
    close(got, ref, 2e-5, f"MBConv stride 2 {shape}")


def test_same_pad_is_asymmetric_on_even_sides():
    x = torch.ones(1, 1, 4, 5)
    # H 4 → 2 outputs: pad (0, 1); W 5 → 3 outputs: pad (1, 1)
    assert TI.same_pad(x, 3, 2).shape == (1, 1, 5, 7)
    y = TI.same_pad(x, 3, 2)
    assert y[0, 0, 0, 1] == 1 and y[0, 0, 4, 1] == 0 and y[0, 0, 1, 0] == 0


@pytest.mark.parametrize("dilation,stride", [(1, 1), (2, 1), (1, 2)])
def test_scbottleneck_on_a_map_not_a_multiple_of_4(dilation, stride):
    """The gate's AvgPool(4) map (2 × 3 from 10 × 14) upsampled back with
    half-pixel centres (torch's ``nearest-exact``; ``nearest`` is off)."""
    x = np.random.default_rng(3).normal(0, 1, (2, 10, 14, 16)).astype(
        np.float32)
    jm = JI.SCBottleneck(8, stride, dilation)
    tm = TI.SCBottleneck(16, 8, stride, dilation)
    v = port_variables(tm, seed=3)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    close(got, ref, 2e-5, f"SCBottleneck d{dilation} s{stride}")


def test_repvgg_fold_equals_jax_fold_and_the_train_layout(outputs):
    tm, v, runs = outputs["RepVGG"]
    folded = TI.repvgg_reparameterize(tm.state_dict())
    deploy = TI.RepVGG(nOut=16, num_blocks=(1, 1, 1, 1),
                       width=(0.25, 0.25, 0.25, 0.5), deploy=True)
    deploy.load_state_dict(folded, strict=True)
    deploy.eval()
    ref = flatten_dict(jax.tree.map(np.asarray,
                                    JI.repvgg_reparameterize(v)["params"]))
    got = flatten_dict(params_to_jax(folded)[0])
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], 1e-6, "/".join(k))
    x, ev, _, _ = runs[0]
    with torch.no_grad():
        close(deploy(t(x)).numpy(), ev, 1e-5, "RepVGG deploy vs train layout")
    with pytest.raises(ValueError, match="statistics"):
        TI.repvgg_reparameterize({k: p for k, p in tm.state_dict().items()
                                  if "running" not in k})


# the builders at their defaults: (registered name, JAX builder)
DEFAULTS = {"EfficientNet": JI.build_efficientnet,
            "EfficientNetv2": JI.build_efficientnetv2,
            "RepVGG": JI.build_repvgg, "SCnet": JI.build_scnet,
            "DPN": JI.build_dpn}
# the int8 table at the defaults (JAX's rule: a Dense or a stride-1,
# ungrouped 1-D conv with K >= 512 and N >= 128)
DEFAULT_INT8 = {"EfficientNet": {"Dense_0"}, "EfficientNetv2": {"Dense_0"},
                "RepVGG": {"Dense_0", "RepVGGBlock_47/Dense_0"},
                "SCnet": {"Dense_0"}, "DPN": {"Dense_0"}}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_builder_defaults_tree_and_int8_table(name):
    torch.set_num_threads(2)
    x = feats((1, 40, 80), seed=4)
    jm = DEFAULTS[name](feature_type="melspectrogram")
    tm = TB.build_model(name, feature_type="melspectrogram", n_mels=80)
    tree, keys = jax_tree_and_quant_keys(jm, jnp.asarray(x))
    assert port_tree(tm) == tree
    got = set(calibrate_act_scales(tm, t(x)))
    assert got == keys == DEFAULT_INT8[name]


def test_int8_rule_at_low_floors_matches_jax():
    """At floors low enough that the small models' layers pass, the port
    quantizes what JAX quantizes: Dense layers, never a 2-D conv."""
    from speakerverification_tpu import quant as jq
    from speakerverification_tpu_torch import quant as tq
    x = feats((1, 40, 24), seed=5)
    for name in ("EfficientNetV2", "RepVGG", "DPN"):
        make_j, make_t, _ = CASES[name]
        jm, tm = make_j(), make_t()
        _, keys = jax_tree_and_quant_keys(jm, jnp.asarray(x),
                                          jq.QuantConfig(min_k=8, min_n=8))
        got = set(calibrate_act_scales(tm, t(x), config=tq.QuantConfig(
            min_k=8, min_n=8)))
        assert got == keys and got, name
        assert all("Dense" in k for k in got), name


def test_dropout_draws_from_the_generator():
    tm = TI.EfficientNet(nOut=8, width_coeff=1.0, depth_coeff=0.3,
                         dropout_rate=0.5).train()
    x = t(feats((2, 40, 24), seed=6))
    g = torch.Generator()
    with torch.no_grad():
        a = tm(x, g.manual_seed(1))
        b = tm(x, g.manual_seed(1))
        c = tm(x, g.manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        tm(x)
