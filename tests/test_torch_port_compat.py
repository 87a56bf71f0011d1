"""The port's reference-checkpoint porters (``compat/torch_port.py``)
against the JAX package's, for every one of the 30 ``_PORTERS`` names.

The reference's torch modules are not here, so each case makes the
reference's state-dict layout itself (``_torch_port_compat_refs``) at a
small width, proves it with JAX's porter against ``jax.eval_shape`` of
the JAX model's init, fills it with seeded values in the reference's
wrapper layout (``module.__S__.``), and then holds:

* the port's porter to JAX's, leaf for leaf, bit for bit and dtype for
  dtype;
* ``state_dict_from_reference`` to the port's model: it loads with
  ``strict=True``;
* for ``ECAPA_TDNN`` and ``Raw3_ECAPA``, the port's model with the
  ported weights to the JAX model with JAX-ported weights on the same
  waves, at the tolerance the other parity tests of these models use
  (``max|port − jax| ≤ 1e-4 · max|jax|``,
  ``tests/test_torch_port_models.py``).

The full-width manifest ``tests/data/raw3_ecapa.torch_shapes.json``
(``chip_smoke.py``'s path P) is proven the same way.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_compat_refs as R
from speakerverification_tpu.compat import torch_port as JP
from speakerverification_tpu.compat.torch_export import (
    porter_args as jax_porter_args,
)
from speakerverification_tpu_torch.compat import torch_port as TP
from speakerverification_tpu_torch.config import read_config
from test_torch_port_helpers import close

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(R.ARCHS)
REL = 1e-4
_CASES: dict = {}
_COMMITTED = R.small_manifests()


def case(arch: str) -> dict:
    """The arch's flax shapes, manifest and seeded reference values,
    made once per module."""
    if arch not in _CASES:
        h, over = R.arch_encoders(arch)
        params, stats = R.jax_init_shapes(h, over)
        man = R.make_manifest(arch, params, stats)
        arrays = R.reference_arrays(man, seed=sorted(R.ARCHS).index(arch))
        _CASES[arch] = dict(h=h, over=over, params=params, stats=stats,
                            manifest=man, arrays=arrays,
                            sd=R.wrapped(arrays))
    return _CASES[arch]


def _flat(params, stats) -> dict:
    return {**{f"params/{k}": v for k, v in R.leaf_shapes(params).items()},
            **{f"batch_stats/{k}": v
               for k, v in R.leaf_shapes(stats).items()}}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _jax_port(c, arch):
    sd = JP._strip_reference_prefixes(c["sd"])
    return JP._PORTERS[arch](sd, jax_porter_args(**R.porter_kw(arch)))


def test_the_registry_has_jax_s_thirty_names():
    assert sorted(TP._PORTERS) == sorted(JP._PORTERS) == ARCHS
    assert len(ARCHS) == 30
    for name in JP.__all__:
        assert callable(getattr(TP, name)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_manifest_is_proven_by_jax_s_porter(arch):
    """JAX's porter, fed the manifest's arrays, yields exactly the keys
    and shapes of the JAX model's init; the committed manifest the
    reverse-port tests read is this one."""
    c = case(arch)
    assert _COMMITTED[arch] == c["manifest"]
    jp, js = _jax_port(c, arch)
    got = {k: tuple(np.shape(v)) for k, v in
           {**{f"params/{k}": v for k, v in _leaves(jp).items()},
            **{f"batch_stats/{k}": v
               for k, v in _leaves(js).items()}}.items()}
    want = _flat(c["params"], c["stats"])
    assert got == want, sorted(set(got.items()) ^ set(want.items()))[:6]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_porter_equals_jax_s_bit_for_bit(arch):
    c = case(arch)
    jp, js = _jax_port(c, arch)
    tp, ts = TP.port_reference(c["sd"], arch, **R.porter_kw(arch))
    for what, want, got in (("params", jp, tp), ("batch_stats", js, ts)):
        w, g = _leaves(want), _leaves(got)
        assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w))[:5])
        for k in w:
            assert g[k].dtype == w[k].dtype, (what, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_from_reference_loads_strict(arch):
    torch.set_num_threads(2)
    c = case(arch)
    backbone = R.port_encoder(c["h"], c["over"]).backbone
    sd = TP.state_dict_from_reference(c["sd"], arch, like=backbone,
                                      **R.porter_kw(arch))
    backbone.load_state_dict(sd, strict=True)
    some = next(k for k in sd if k.endswith("weight"))
    assert torch.equal(backbone.state_dict()[some], sd[some])


def test_full_width_raw3_ecapa_manifest_is_proven():
    """``tests/data/raw3_ecapa.torch_shapes.json`` (path P's reference
    checkpoint) is the full-width ``Raw3_ECAPA`` of
    ``yaml/raw3_ecapa.yaml``: JAX's porter turns it into exactly the
    JAX init's tree."""
    man = json.loads((ROOT / "tests" / "data" /
                      "raw3_ecapa.torch_shapes.json").read_text())
    h = read_config(ROOT / "yaml" / "raw3_ecapa.yaml")
    params, stats = R.jax_init_shapes(h)
    assert man == R.make_manifest("Raw3_ECAPA", params, stats, model_kw={})
    probe = {k: np.zeros(v, np.float32) for k, v in man.items()}
    jp, js = JP._PORTERS["Raw3_ECAPA"](probe, jax_porter_args())
    got = {f"params/{k}": tuple(np.shape(v)) for k, v in _leaves(jp).items()}
    got.update({f"batch_stats/{k}": tuple(np.shape(v))
                for k, v in _leaves(js).items()})
    assert got == _flat(params, stats)
    assert man["rawnet.preprocess.0.flipped_filter"] == [1, 1, 2]
    assert sum(k.endswith("num_batches_tracked") for k in man) == \
        sum(k.endswith("running_mean") for k in man)


def test_strip_reference_prefixes_and_the_ecapa_loader(tmp_path):
    c = case("ECAPA_TDNN")
    sd = dict(c["sd"])
    sd["module.__L__.weight"] = torch.zeros(3, 48)
    sd["module.__S__.compute_features.mel.weight"] = torch.zeros(2)
    stripped = TP._strip_reference_prefixes(sd)
    assert stripped.keys() == c["arrays"].keys()
    path = tmp_path / "ref.pt"
    torch.save({"state_dict": sd}, path)
    got = TP.load_reference_checkpoint(path, n_blocks=4, res2net_scale=4)
    want = JP.load_reference_checkpoint(path, n_blocks=4, res2net_scale=4)
    for g, w in zip(got, want):
        gl, wl = _leaves(g), _leaves(w)
        assert sorted(gl) == sorted(wl)
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k])


def test_state_dict_from_reference_refuses_an_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch"):
        TP.state_dict_from_reference({}, "NoSuchNet")


@pytest.mark.parametrize("arch", ["ECAPA_TDNN", "Raw3_ECAPA"])
def test_forward_with_ported_weights_matches_jax(arch):
    """The port's encoder with ``state_dict_from_reference``'s weights
    against the JAX encoder with JAX-ported weights, on the same waves,
    in eval mode: ``max|port − jax| ≤ 1e-4 · max|jax|``."""
    torch.set_num_threads(2)
    c = case(arch)
    jm = R.jax_encoder(c["h"], c["over"])
    jp, js = _jax_port(c, arch)
    x = (0.1 * np.random.default_rng(5).standard_normal((2, 8000))
         ).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(
        {"params": {"backbone": jp}, "batch_stats": {"backbone": js}},
        jnp.asarray(x)))
    tm = R.port_encoder(c["h"], c["over"]).eval()
    tm.backbone.load_state_dict(
        TP.state_dict_from_reference(c["sd"], arch, **R.porter_kw(arch)),
        strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    close(got, ref, REL, arch)
