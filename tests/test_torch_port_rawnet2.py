"""The RawNet2 family against the JAX package on the CPU, from the same
weights (carried by ``weights.params_from_jax``, BatchNorm statistics
randomized) and the same seeded inputs.

Small widths: ``RawNet2Custom(filters=(8, 8, 16, 16, 32, 32),
gru_node=16)`` and RawNet2 at (8, 16) filters, on waves of 9,000
samples (3⁷·4 + 250: four GRU steps after the sinc front's 251 taps and
seven pools of 3). Tolerances, each of the largest reference magnitude:

* fp32 eval: 1e-5 for the blocks, the sinc bank, the LayerNorm and the
  GRU; 2e-5 for the models (a model chains ~30 layers whose sums both
  packages take in different orders);
* fp32 train mode (batch statistics, running statistics updated as
  flax does): 1e-4 for the outputs and the new running statistics
  (a batch-statistic BatchNorm divides by the batch's spread, which
  magnifies the order-of-summation differences);
* bf16 (bf16 weights and wave, fp32 statistics): the output dtype is
  JAX's (fp32 where the GRU's fp32 carry promotes, bf16 otherwise), and
  the port's output lies within 8e-2 (20 bf16 ulps of the largest
  output) of JAX's bf16 output and of the fp32 one. ~30 bf16-rounded
  layers put either package 0.6–5.3 % from fp32 and 0.7–5.7 % from the
  other (measured over three seeds): noise of the same size in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from speakerverification_tpu.models.rawnet2 import (
    RawNet2 as JRawNet2,
    SampleLayerNorm as JSampleLayerNorm,
)
from speakerverification_tpu.models.rawnet2_custom import (
    RawNet2Custom as JRawNet2Custom,
)
from speakerverification_tpu.models.rawnet_blocks import (
    FRM as JFRM,
    RawNetBasicBlock as JRawNetBasicBlock,
    ResidualBlockFRM as JResidualBlockFRM,
)
from speakerverification_tpu.ops.sinc import SincConv as JSincConv
from speakerverification_tpu_torch.models.rawnet2 import (
    RawNet2 as TRawNet2,
    SampleLayerNorm as TSampleLayerNorm,
)
from speakerverification_tpu_torch.models.rawnet2_custom import (
    RawNet2Custom as TRawNet2Custom,
)
from speakerverification_tpu_torch.models.rawnet_blocks import (
    FRM as TFRM,
    RawNetBasicBlock as TRawNetBasicBlock,
    ResidualBlockFRM as TResidualBlockFRM,
)
from speakerverification_tpu_torch.models.recurrent import GRUCell as TGRUCell
from speakerverification_tpu_torch.ops.sinc import SincConv as TSincConv
from speakerverification_tpu_torch.weights import cast_copy, params_from_jax

from test_torch_port_helpers import close, init_pair, ncl_to_nlc, t

T = 9000
SMALL = dict(nOut=12, filters=(8, 8, 16, 16, 32, 32), gru_node=16,
             att_dim=8)
SMALL_RAWNET2 = dict(nOut=12, first_filters=8,
                     block_filters=((8, 8), (8, 8), (8, 16), (16, 16),
                                    (16, 16), (16, 16)), gru_node=16)


def _wave(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).normal(0, 1, shape)
            ).astype(np.float32)


def _nlc(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _perturb_affine(variables, seed):
    """The sample LayerNorm's gamma/beta away from 1/0 (its init), so
    that the per-sample affine is exercised."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(variables["params"])
    for path in flat:
        if path[-1] == "gamma":
            flat[path] = rng.uniform(0.5, 1.5, flat[path].shape).astype(
                np.float32)
        elif path[-1] == "beta":
            flat[path] = rng.normal(0, 0.1, flat[path].shape).astype(
                np.float32)
    return {**variables, "params": unflatten_dict(flat)}


def _load(tm, variables):
    tm.load_state_dict(params_from_jax(variables["params"],
                                       variables.get("batch_stats"),
                                       like=tm), strict=True)
    tm.eval()


@pytest.mark.parametrize("grid", ["linspace", "arange"])
def test_sinc_conv_window_grids(grid):
    x = _wave((2, 3000), seed=1)
    jm = JSincConv(8, 251, sample_rate=16000, init_low_hz=10.0,
                   window_grid=grid)
    tm = TSincConv(8, 251, sample_rate=16000, init_low_hz=10.0,
                   window_grid=grid)
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))            # [B, F, C]
    with torch.no_grad():
        got = ncl_to_nlc(tm(t(x)))
    close(got, ref, 1e-5, f"SincConv {grid}")


def test_sinc_conv_default_grid_is_arange():
    assert TSincConv(4).window_grid == "arange"
    with pytest.raises(ValueError, match="window_grid"):
        TSincConv(4, window_grid="geomspace")


def test_sample_layer_norm():
    x = _wave((3, 500), seed=2) + 0.05
    jm = JSampleLayerNorm()
    tm = TSampleLayerNorm(500)
    v = _perturb_affine(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x))), 3)
    _load(tm, v)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 1e-5, "SampleLayerNorm")
    with pytest.raises(ValueError, match="500-sample crops"):
        tm(torch.zeros(3, 499))


BLOCKS = [
    ("FRM", lambda: (JFRM(8), TFRM(8)), (2, 30, 8)),
    ("RawNetBasicBlock", lambda: (JRawNetBasicBlock(8),
                                  TRawNetBasicBlock(8, 8)), (2, 30, 8)),
    ("RawNetBasicBlock-widen-pool",
     lambda: (JRawNetBasicBlock(16, downsample=True),
              TRawNetBasicBlock(8, 16, downsample=True)), (2, 30, 8)),
    ("ResidualBlockFRM-first",
     lambda: (JResidualBlockFRM(8, 8, first=True),
              TResidualBlockFRM(8, 8, first=True)), (2, 30, 8)),
    ("ResidualBlockFRM-widen",
     lambda: (JResidualBlockFRM(8, 16), TResidualBlockFRM(8, 16)),
     (2, 30, 8)),
]


@pytest.mark.parametrize("name,make,shape", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_blocks(name, make, shape, train):
    x = _nlc(shape, seed=4)
    jm, tm = make()
    kw = {} if name == "FRM" else {"train": False}
    v = init_pair(jm, tm, jnp.asarray(x), **kw)
    if train and name != "FRM":
        ref, upd = jm.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        tm.train()
    else:
        ref, upd = jm.apply(v, jnp.asarray(x), **kw), None
    with torch.no_grad():
        got = ncl_to_nlc(tm(t(np.transpose(x, (0, 2, 1)))))
    close(got, np.asarray(ref), 1e-4 if upd else 1e-5, name)
    if upd:
        _close_stats(tm, upd["batch_stats"], 1e-4)


def _close_stats(tm, batch_stats, rel):
    """The port's running statistics against flax's updated ones."""
    state = tm.state_dict()
    for path, ref in flatten_dict(batch_stats).items():
        key = ".".join(path[:-1]) + (
            ".running_mean" if path[-1] == "mean" else ".running_var")
        close(state[key].numpy(), np.asarray(ref), rel, key)


class _JGRU(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return fnn.RNN(fnn.GRUCell(features=self.features))(x)


class _TGRU(torch.nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.GRUCell_0 = TGRUCell(cin, features)

    def forward(self, x):
        return self.GRUCell_0(x)


def test_gru_cell_matches_flax():
    """flax's layout (``ir/iz/in`` with a bias, ``hr/hz`` without, ``hn``
    with) and update, the carry from zero; over 7 steps."""
    x = _nlc((3, 7, 8), seed=5)
    jm, tm = _JGRU(16), _TGRU(8, 16)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)))
    assert set(flatten_dict(v["params"])) == {
        ("GRUCell_0", k, leaf) for k in ("ir", "iz", "in", "hn")
        for leaf in ("kernel", "bias")} | {
        ("GRUCell_0", k, "kernel") for k in ("hr", "hz")}
    _load(tm, v)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 1e-5, "GRU")


def test_gru_cell_keeps_an_fp32_carry_under_bf16():
    """bf16 weights and input: the recurrent products promote against the
    fp32 carry, so the states are fp32, as JAX's are."""
    x = _nlc((3, 7, 8), seed=6)
    jm, tm = _JGRU(16), _TGRU(8, 16)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                         jnp.asarray(x)))
    _load(tm, v)
    vb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    ref = jm.apply(vb, jnp.asarray(x, jnp.bfloat16))
    tb = cast_copy(tm, torch.bfloat16)
    with torch.no_grad():
        got = tb(t(x).to(torch.bfloat16))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    close(got.numpy(), np.asarray(ref), 2e-2, "GRU bf16")


CUSTOM = [(f, a) for f in ("sinc", "conv") for a in ("asp", "gru", "sap")]


def _custom_pair(front, agg):
    return (JRawNet2Custom(front_proc=front, aggregate=agg, **SMALL),
            TRawNet2Custom(front_proc=front, aggregate=agg, n_samples=T,
                           **SMALL))


def _init_custom(front, agg, seed):
    x = _wave((3, T), seed=seed)
    jm, tm = _custom_pair(front, agg)
    v = init_pair(jm, tm, jnp.asarray(x))
    v = _perturb_affine(v, seed)
    _load(tm, v)
    return x, jm, tm, v


@pytest.mark.parametrize("front,agg", CUSTOM,
                         ids=[f"{f}-{a}" for f, a in CUSTOM])
def test_rawnet2_custom_eval(front, agg):
    x, jm, tm, v = _init_custom(front, agg, seed=7)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (3, 12)
    close(got, ref, 2e-5, f"RawNet2Custom {front} {agg}")


@pytest.mark.parametrize("front,agg", CUSTOM,
                         ids=[f"{f}-{a}" for f, a in CUSTOM])
def test_rawnet2_custom_train_mode(front, agg):
    """Training mode: batch statistics in every BatchNorm and flax's
    running-statistics update (the GRU variants included)."""
    x, jm, tm, v = _init_custom(front, agg, seed=8)
    ref, upd = jm.apply(v, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, np.asarray(ref), 1e-4, f"RawNet2Custom {front} {agg} train")
    _close_stats(tm, upd["batch_stats"], 1e-4)


@pytest.mark.parametrize("front,agg", CUSTOM,
                         ids=[f"{f}-{a}" for f, a in CUSTOM])
def test_rawnet2_custom_bf16_dtypes(front, agg):
    """bf16 weights and wave, fp32 statistics: the embedding's dtype is
    JAX's (fp32 from the GRU, bf16 from asp and sap)."""
    torch.set_num_threads(2)
    x, jm, tm, v = _init_custom(front, agg, seed=9)
    ref32 = np.asarray(jm.apply(v, jnp.asarray(x)))
    vb = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 v["params"]),
          "batch_stats": v["batch_stats"]}
    ref = jm.apply(vb, jnp.asarray(x, jnp.bfloat16))
    tb = cast_copy(tm, torch.bfloat16)
    with torch.no_grad():
        got = tb(t(x).to(torch.bfloat16))
    want = torch.float32 if agg == "gru" else torch.bfloat16
    assert str(ref.dtype) == str(want).removeprefix("torch."), ref.dtype
    assert got.dtype == want
    close(got.float().numpy(), np.asarray(ref, np.float32), 8e-2,
          f"RawNet2Custom {front} {agg} bf16")
    close(got.float().numpy(), ref32, 8e-2,
          f"RawNet2Custom {front} {agg} bf16 against fp32")


def test_rawnet2_eval_and_train():
    x = _wave((3, T), seed=10)
    jm = JRawNet2(**SMALL_RAWNET2)
    tm = TRawNet2(n_samples=T, **SMALL_RAWNET2)
    v = _perturb_affine(init_pair(jm, tm, jnp.asarray(x)), 10)
    _load(tm, v)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, 2e-5, "RawNet2")
    ref, upd = jm.apply(v, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, np.asarray(ref), 1e-4, "RawNet2 train")
    _close_stats(tm, upd["batch_stats"], 1e-4)


def test_refusals():
    with pytest.raises(ValueError, match="front_proc"):
        TRawNet2Custom(front_proc="mel", n_samples=T)
    with pytest.raises(ValueError, match="aggregate"):
        TRawNet2Custom(aggregate="max", n_samples=T)
    with pytest.raises(ValueError, match="n_samples"):
        TRawNet2Custom(front_proc="sinc")
    TRawNet2Custom(front_proc="conv")          # no LayerNorm, no length


@pytest.mark.parametrize("front,agg", CUSTOM,
                         ids=[f"{f}-{a}" for f, a in CUSTOM])
def test_weight_bridge_round_trip(front, agg):
    """``params_from_jax(params_to_jax(state))`` gives the state back bit
    for bit (the GRU's six products, ``sap_v``, the LayerNorm)."""
    from speakerverification_tpu_torch.weights import (
        init_weights_,
        params_to_jax,
    )
    _, tm = _custom_pair(front, agg)
    init_weights_(tm, torch.Generator().manual_seed(4))
    state = tm.state_dict()
    back = params_from_jax(*params_to_jax(state), like=tm)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_init_draws_flax_distributions_for_the_new_leaves():
    """``init_weights_``: a GRU's recurrent kernels orthogonal (flax's
    ``orthogonal()``), its input kernels truncated lecun_normal, ``sap_v``
    a standard normal."""
    from speakerverification_tpu_torch.weights import init_weights_
    m = TRawNet2Custom(front_proc="conv", aggregate="sap", nOut=8,
                       filters=(8, 8, 8, 8, 8, 1024), gru_node=16)
    g = TGRUCell(256, 256)
    init_weights_(m, torch.Generator().manual_seed(0))
    init_weights_(g, torch.Generator().manual_seed(1))
    for name in ("hr", "hz", "hn"):
        w = getattr(g, name).weight.double()
        torch.testing.assert_close(w @ w.T, torch.eye(256, dtype=w.dtype),
                                   atol=1e-5, rtol=0)
    assert float(g.ir.weight.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    assert float(g.ir.weight.abs().max()) <= 2 * 256 ** -0.5 / 0.8796 + 1e-6
    assert float(m.sap_v.std()) == pytest.approx(1.0, rel=0.1)
    assert abs(float(m.sap_v.mean())) < 0.1
