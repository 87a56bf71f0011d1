"""TDFbanks and the pooling modules of ``models/pooling_extra.py``, port
against the JAX package (CPU).

* The mel-triangle prototypes and the Gabor init against JAX's (the
  port's own ``hz_to_mel``/``mel_to_hz``), bit for bit on float32.
* ``TDFbanks`` in both modes (``learnfbanks``, whose ``gabor_kernel``
  goes through the weight bridge, and ``Fixed``), with and without
  pre-emphasis and ``mvn``, on 2 waves of 4,000 samples at 16 kHz and
  8 kHz; fp32 either way (a bf16 wave gives bf16 features computed in
  fp32). Tolerance 1e-5 of the largest feature.
* The eight pooling modules on ``[2, 13, 16]`` inputs, parameters drawn
  on the port's side (flax's init distributions: ``v``/``u``/``a_*``
  xavier normal, Dense kernels lecun normal) and carried to JAX by
  ``params_to_jax``. Tolerance 2e-6 of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.models import pooling_extra as JP
from speakerverification_tpu.models import tdfbanks as JT
from speakerverification_tpu_torch.models import pooling_extra as TP
from speakerverification_tpu_torch.models import tdfbanks as TT
from speakerverification_tpu_torch.weights import (
    init_weights_,
    params_from_jax,
    params_to_jax,
)

from test_torch_port_helpers import close, t


def waves(n: int, samples: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, samples))
            ).astype(np.float32)


@pytest.mark.parametrize("nfilters,fs", [(40, 16000), (24, 8000)])
def test_prototypes_and_gabor_init(nfilters, fs):
    np.testing.assert_array_equal(
        TT.mel_triangle_prototypes(nfilters, 0.0, fs / 2, fs, 512),
        JT._mel_triangle_prototypes(nfilters, 0.0, fs / 2, fs, 512))
    k = fs * 25 // 1000 + 1
    np.testing.assert_array_equal(TT.gabor_init(nfilters, fs, k),
                                  JT._gabor_init(nfilters, fs, k))


CASES = {
    "learnfbanks": {},
    "learnfbanks preemp mvn": {"preemp": True, "mvn": True},
    "Fixed": {"mode": "Fixed"},
    "Fixed 8 kHz, 24 filters, mvn": {"mode": "Fixed", "sample_rate": 8000,
                                     "nfilters": 24, "mvn": True},
    "no compression": {"compression": "none", "preemp": True},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tdfbanks_matches_jax(name):
    opts = CASES[name]
    x = waves(2, 4000, seed=1)
    jm, tm = JT.TDFbanks(**opts), TT.TDFbanks(**opts)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    if opts.get("mode") == "Fixed":
        assert "params" not in v and not tm.state_dict()
    else:
        # perturb the learnable kernel, so the bridge's copy is the one used
        rng = np.random.default_rng(2)
        kern = np.asarray(v["params"]["gabor_kernel"])
        v = {"params": {"gabor_kernel": kern * rng.uniform(
            0.8, 1.2, kern.shape).astype(np.float32)}}
        tm.load_state_dict(params_from_jax(v["params"], like=tm))
        assert tm.gabor_kernel.shape == kern.shape
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x))
    assert got.dtype == torch.float32
    close(got.numpy(), ref, 1e-5, name)
    with torch.no_grad():
        half = tm(t(x).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        half.float().numpy(),
        tm(t(x).to(torch.bfloat16).float()).to(torch.bfloat16).float()
        .detach().numpy())


POOLS = {
    "AttentionPooling": (lambda: JP.AttentionPooling(),
                         lambda: TP.AttentionPooling(16)),
    "MultiHeadAttentionPooling": (lambda: JP.MultiHeadAttentionPooling(4),
                                  lambda: TP.MultiHeadAttentionPooling(16, 4)),
    "DoubleMHA": (lambda: JP.DoubleMHA(4), lambda: TP.DoubleMHA(16, 4)),
    "TemporalPyramidPooling": (lambda: JP.TemporalPyramidPooling((1, 2, 4)),
                               lambda: TP.TemporalPyramidPooling((1, 2, 4))),
    "GlobalAveragePooling": (lambda: JP.GlobalAveragePooling(),
                             lambda: TP.GlobalAveragePooling()),
    "SimpleSelfAttention": (lambda: JP.SimpleSelfAttention(),
                            lambda: TP.SimpleSelfAttention(16)),
    "GraphAttentionLayer": (lambda: JP.GraphAttentionLayer(12),
                            lambda: TP.GraphAttentionLayer(16, 12)),
    "GraphPool": (lambda: JP.GraphPool(0.5), lambda: TP.GraphPool(16, 0.5)),
}
SHAPES = {"AttentionPooling": (2, 16), "MultiHeadAttentionPooling": (2, 16),
          "DoubleMHA": (2, 4), "TemporalPyramidPooling": (2, 112),
          "GlobalAveragePooling": (2, 16), "SimpleSelfAttention": (2, 16),
          "GraphAttentionLayer": (2, 13, 12), "GraphPool": (2, 6, 16)}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling_matches_jax(name):
    x = np.random.default_rng(3).normal(0, 1, (2, 13, 16)).astype(np.float32)
    jm, tm = POOLS[name][0](), POOLS[name][1]()
    init_weights_(tm, torch.Generator().manual_seed(4))
    params, _ = params_to_jax(tm.state_dict())
    v = {"params": params} if params else {}
    if params:
        # the bridge carries the module back unchanged
        back = params_from_jax(params, like=tm)
        assert all(torch.equal(back[k], p) for k, p in
                   tm.state_dict().items())
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"]
        assert jax.tree.map(lambda a: a.shape, shapes) == \
            jax.tree.map(lambda a: a.shape, params)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == SHAPES[name]
    close(got, ref, 2e-6, name)


def test_pooling_parameters_take_flax_init_scales():
    """``v`` [C, 1] and the GAT vectors draw xavier normal (std
    √(2/(fan_in + fan_out))), not zeros."""
    tm = TP.AttentionPooling(256)
    init_weights_(tm, torch.Generator().manual_seed(5))
    std = float(tm.v.std())
    assert abs(std - (2 / 257) ** 0.5) < 0.2 * (2 / 257) ** 0.5
    gat = TP.GraphAttentionLayer(16, 300)
    init_weights_(gat, torch.Generator().manual_seed(6))
    assert float(gat.a_src.abs().max()) > 0
