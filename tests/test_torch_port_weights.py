"""``weights.params_from_jax`` covers every leaf of the JAX trees.

Shapes come from ``jax.eval_shape`` (no compile), so the full-width
models are checked too: every flax leaf must land on a port key of the
same shape, and every port key must be filled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from speakerverification_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA
from speakerverification_tpu.models.hybrids import build_raw3_ecapa as j_raw3
from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN as TECAPA
from speakerverification_tpu_torch.models.hybrids import build_raw3_ecapa as t_raw3
from speakerverification_tpu_torch.weights import params_from_jax, params_to_jax


def _zeros_like_tree(module, x):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)


CASES = {
    "raw3_ecapa_small": lambda: (j_raw3(nOut=256, C=64), t_raw3(nOut=256, C=64),
                                 jnp.zeros((1, 4000))),
    "raw3_ecapa": lambda: (j_raw3(nOut=512), t_raw3(nOut=512),
                           jnp.zeros((1, 16000))),
    "ecapa_tdnn": lambda: (JECAPA(lin_neurons=192), TECAPA(lin_neurons=192),
                           jnp.zeros((1, 201, 80))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_leaf_is_placed(case):
    jm, tm, x = CASES[case]()
    v = _zeros_like_tree(jm, x)
    state = params_from_jax(v["params"], v["batch_stats"], like=tm)
    n_flax = sum(len(flatten_dict(v[c])) for c in v)
    n_bn = len(flatten_dict(v["batch_stats"])) // 2
    # every flax leaf plus one num_batches_tracked per BatchNorm
    assert len(state) == n_flax + n_bn == len(tm.state_dict())
    tm.load_state_dict(state, strict=True)


def _small():
    jm, tm, x = CASES["raw3_ecapa_small"]()
    v = _zeros_like_tree(jm, x)
    return tm, flatten_dict(v["params"]), flatten_dict(v["batch_stats"])


def test_missing_leaf_raises():
    tm, params, stats = _small()
    params.pop(next(k for k in params if k[-1] == "kernel"))
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(unflatten_dict(params), unflatten_dict(stats), like=tm)


def test_extra_leaf_raises():
    tm, params, stats = _small()
    params[("extra", "Conv_0", "kernel")] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(KeyError, match="left over"):
        params_from_jax(unflatten_dict(params), unflatten_dict(stats), like=tm)


def test_unknown_leaf_and_half_batchnorm_raise():
    tm, params, stats = _small()
    bad = dict(params)
    bad[("raw_branch", "mystery")] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no port counterpart"):
        params_from_jax(unflatten_dict(bad), unflatten_dict(stats))
    stats.pop(next(k for k in stats if k[-1] == "var"))
    with pytest.raises(KeyError, match="lacks its running_var"):
        params_from_jax(unflatten_dict(params), unflatten_dict(stats))


@pytest.mark.parametrize("path", [("raw_branch", "b"), ("Dense_0", "w"),
                                  ("backbone", "gamma"), ("Dense_0", "beta"),
                                  ("loss", "Softmax_0", "w"),
                                  ("loss", "Dense_0", "weight")])
def test_common_names_only_under_their_owners(path):
    """``gamma``/``beta`` pass through only under a ``SampleLayerNorm_*``
    (or at the root of a LayerNorm's own tree), ``w``/``b`` only at
    ``loss`` or under a metric head, ``weight`` only as a margin head's
    matrix: elsewhere such a leaf has no place."""
    leaf = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no port counterpart"):
        params_from_jax(unflatten_dict({path: leaf}))


def test_softmax_head_dense_is_a_kernel():
    """A plain Softmax head's Linear goes to flax as a Dense kernel
    ``[nOut, nClasses]``, not as a margin head's matrix."""
    w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    params, _ = params_to_jax({"loss.Dense_0.weight": w,
                               "loss.Dense_0.bias": torch.zeros(3)})
    assert set(params["loss"]["Dense_0"]) == {"kernel", "bias"}
    np.testing.assert_array_equal(params["loss"]["Dense_0"]["kernel"],
                                  w.numpy().T)


def test_layouts():
    params = {"Conv_0": {"kernel": np.arange(24, dtype=np.float32
                                             ).reshape(2, 3, 4),
                         "bias": np.ones(4, np.float32)},
              "Dense_0": {"kernel": np.arange(6, dtype=np.float32
                                              ).reshape(2, 3)}}
    state = params_from_jax(params)
    np.testing.assert_array_equal(state["Conv_0.weight"].numpy(),
                                  params["Conv_0"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["Dense_0.weight"].numpy(),
                                  params["Dense_0"]["kernel"].T)
