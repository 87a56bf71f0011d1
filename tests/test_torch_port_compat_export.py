"""The port's reverse porter (``compat/torch_export.py``) and both
converter CLIs.

* ``reverse_port`` inverts every one of the 30 porters exactly on a
  seeded reference-layout state dict (``_torch_port_compat_refs``); a
  GRU's r/z bias pairs, which the forward port folds into one sum, are
  held by their sums, as the JAX package's test holds them.
* The forward CLI (``python -m
  speakerverification_tpu_torch.compat.torch_port``) on a wrapped
  reference ``.pt`` writes the msgpack and the ``.torch_shapes.json``
  manifest that JAX's CLI writes on the same file: read by flax's
  ``msgpack_restore``, leaf for leaf; for ECAPA_TDNN,
  Raw3_ECAPA and the six families of JAX's
  ``test_converter_cli_families``.
* The reverse CLI with ``--shapes`` gives back the stripped backbone bit
  for bit; the converted file serves and resumes: the loss head's
  centres land in a port train state through ``load_params_only``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization as fser

import _torch_port_compat_refs as R
from speakerverification_tpu.compat import torch_port as JP
from speakerverification_tpu_torch.compat import torch_export as TE
from speakerverification_tpu_torch.compat import torch_port as TP

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(R.ARCHS)
CLI_ARCHS = ["ECAPA_TDNN", "Raw3_ECAPA", "ResNetSE34", "SCnet", "RawNet3",
             "RawNet2", "RawNeXt", "TitaNet"]
_MANIFESTS = R.small_manifests()
_CASES: dict = {}


def case(arch: str) -> dict:
    """The arch's committed manifest (proven in
    ``test_torch_port_compat.py``) and seeded reference values."""
    if arch not in _CASES:
        h, over = R.arch_encoders(arch)
        man = _MANIFESTS[arch]
        _CASES[arch] = dict(h=h, over=over, manifest=man,
                            arrays=R.reference_arrays(man, seed=7))
    return _CASES[arch]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _gru_keys(man):
    return {k for k in man if ".bias_ih_l" in k or ".bias_hh_l" in k}


def assert_roundtrip(sd0: dict, sd1: dict) -> None:
    """``sd1`` equals ``sd0`` key for key, bit for bit; a GRU's r/z bias
    rows compare by the sum the forward port keeps."""
    assert sorted(sd1) == sorted(sd0)
    gru = _gru_keys(sd0)
    for k, v in sd0.items():
        got = np.asarray(sd1[k])
        assert got.dtype == np.asarray(v).dtype, k
        assert got.shape == np.shape(v), k
        if k in gru:
            continue
        np.testing.assert_array_equal(got, v, err_msg=k)
    for k in gru:
        if ".bias_ih_l" not in k:
            continue
        hh = k.replace(".bias_ih_l", ".bias_hh_l")
        H = sd0[k].shape[0] // 3
        np.testing.assert_array_equal(sd1[k][:2 * H] + sd1[hh][:2 * H],
                                      sd0[k][:2 * H] + sd0[hh][:2 * H])
        np.testing.assert_array_equal(sd1[k][2 * H:], sd0[k][2 * H:])
        np.testing.assert_array_equal(sd1[hh][2 * H:], sd0[hh][2 * H:])


@pytest.mark.parametrize("arch", ARCHS)
def test_reverse_port_roundtrips(arch):
    c = case(arch)
    params, stats = TP.port_reference(c["arrays"], arch, **R.porter_kw(arch))
    tree = {"params": {"backbone": params},
            "batch_stats": {"backbone": stats}}
    sd1 = TE.reverse_port(tree, c["manifest"], arch,
                          TE.porter_args(**R.porter_kw(arch)))
    assert_roundtrip(c["arrays"], sd1)


def test_reverse_port_rejects_another_family():
    c = case("ECAPA_TDNN")
    with pytest.raises((ValueError, KeyError)):
        TE.reverse_port({"params": {"backbone": {"bogus": np.zeros(3)}},
                         "batch_stats": {"backbone": {}}},
                        c["manifest"], "ECAPA_TDNN",
                        TE.porter_args(res2net_scale=4))
    with pytest.raises(KeyError, match="unknown arch"):
        TE.reverse_port({}, c["manifest"], "NoSuchNet")


def test_reverse_port_carries_the_loss_head_and_refuses_unknown_buffers():
    c = case("ECAPA_TDNN")
    params, stats = TP.port_reference(c["arrays"], "ECAPA_TDNN",
                                      res2net_scale=4)
    centres = np.random.default_rng(0).normal(size=(10, 48)) \
        .astype(np.float32)
    tree = {"params": {"backbone": params, "loss": {"weight": centres}},
            "batch_stats": {"backbone": stats}}
    shapes = dict(c["manifest"], **{"dead.buffer": [3]})
    with pytest.raises(ValueError, match="never read"):
        TE.reverse_port(tree, shapes, "ECAPA_TDNN",
                        TE.porter_args(res2net_scale=4))
    sd1 = TE.reverse_port(tree, shapes, "ECAPA_TDNN",
                          TE.porter_args(res2net_scale=4),
                          allow_zero_fill=True)
    np.testing.assert_array_equal(sd1["__L__.weight"], centres)
    np.testing.assert_array_equal(sd1["dead.buffer"], np.zeros(3))
    filled = TE.reverse_port(tree, shapes, "ECAPA_TDNN",
                             TE.porter_args(res2net_scale=4),
                             fill_from={"dead.buffer": np.ones(3)})
    np.testing.assert_array_equal(filled["dead.buffer"], np.ones(3))
    assert TE.shapes_of_state_dict(R.wrapped(c["arrays"])) == c["manifest"]


def _argv(arch, src, out):
    argv = ["--arch", arch, "--input", str(src), "--output", str(out)]
    kw = R.porter_kw(arch)
    if "res2net_scale" in kw:
        argv += ["--res2net_scale", str(kw["res2net_scale"])]
    return argv


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_converter_cli_writes_what_jax_s_writes(arch, tmp_path, monkeypatch,
                                                capsys):
    c = case(arch)
    centres = np.random.default_rng(1).normal(size=(6, 8)).astype(np.float32)
    src = tmp_path / "ref.pt"
    torch.save(R.wrapped(c["arrays"], head=centres), src)
    TP._main(_argv(arch, src, tmp_path / "port" / "out.msgpack"))
    said = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["torch_port"] + _argv(
        arch, src, tmp_path / "jax" / "out.msgpack"))
    JP._main()
    assert capsys.readouterr().out.replace("/jax/", "/port/") == said
    assert "loss head ported" in said

    got = fser.msgpack_restore((tmp_path / "port" / "out.msgpack")
                               .read_bytes())
    want = fser.msgpack_restore((tmp_path / "jax" / "out.msgpack")
                                .read_bytes())
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(g["params/loss/weight"], centres)
    shapes = json.loads((tmp_path / "port" / "out.msgpack.torch_shapes.json")
                        .read_text())
    assert shapes == json.loads(
        (tmp_path / "jax" / "out.msgpack.torch_shapes.json").read_text())
    assert shapes == c["manifest"]


def test_both_clis_as_modules_roundtrip_the_backbone(tmp_path):
    """``python -m …torch_port`` then ``python -m …torch_export
    --shapes`` gives back the stripped backbone bit for bit, under
    ``--prefix``; the loss head keeps its ``__L__.`` key."""
    c = case("ECAPA_TDNN")
    centres = np.ones((4, 48), np.float32)
    src = tmp_path / "ref.pt"
    torch.save(R.wrapped(c["arrays"], head=centres), src)
    out = tmp_path / "out.msgpack"
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-m",
                    "speakerverification_tpu_torch.compat.torch_port",
                    *_argv("ECAPA_TDNN", src, out)], cwd=ROOT, env=env,
                   check=True, capture_output=True, timeout=300)
    back = tmp_path / "state_dict.pt"
    run = subprocess.run(
        [sys.executable, "-m",
         "speakerverification_tpu_torch.compat.torch_export",
         "--arch", "ECAPA_TDNN", "--input", str(out), "--output", str(back),
         "--shapes", str(out) + ".torch_shapes.json", "--res2net_scale",
         "4", "--prefix", "__S__."], cwd=ROOT, env=env, check=True,
        capture_output=True, text=True, timeout=300)
    assert "verified round-trip" in run.stdout
    sd = torch.load(back, weights_only=True)
    np.testing.assert_array_equal(sd.pop("__L__.weight").numpy(), centres)
    assert_roundtrip(c["arrays"], {k.removeprefix("__S__."): v.numpy()
                                   for k, v in sd.items()})


def test_reverse_cli_takes_like_and_refuses_both_or_neither(tmp_path):
    c = case("RawNet3")
    src = tmp_path / "ref.pt"
    torch.save(R.wrapped(c["arrays"]), src)
    out = tmp_path / "out.msgpack"
    TP._main(_argv("RawNet3", src, out))
    back = tmp_path / "back.pt"
    TE._main(["--arch", "RawNet3", "--input", str(out), "--output",
              str(back), "--like", str(src)])
    assert_roundtrip(c["arrays"], {k: v.numpy() for k, v in
                                   torch.load(back, weights_only=True)
                                   .items()})
    for extra in ([], ["--like", str(src), "--shapes", str(src)]):
        with pytest.raises(SystemExit):
            TE._main(["--arch", "RawNet3", "--input", str(out),
                      "--output", str(back), *extra])


def test_a_converted_checkpoint_resumes_with_its_centres(tmp_path):
    """The trainer's weights-only resume (``training.checkpoint.
    load_params_only``, which it falls back to for a file without an
    optimizer state) restores the backbone and the margin head's
    centres from the converter's msgpack, as JAX's does."""
    from speakerverification_tpu_torch import builder as TB
    from speakerverification_tpu_torch.training import checkpoint as TC
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )

    torch.set_num_threads(2)
    c = case("ECAPA_TDNN")
    h = dict(c["h"], nClasses=6)
    model = TB.encoder_from_hparams(h, with_loss=True)
    centres = np.random.default_rng(2).normal(size=(6, 48)).astype(np.float32)
    src = tmp_path / "ref.pt"
    torch.save(R.wrapped(c["arrays"], head=centres), src)
    out = tmp_path / "out.msgpack"
    TP._main(_argv("ECAPA_TDNN", src, out))
    state = create_train_state(model, TB.optimizer_from_hparams(h), 0)
    with pytest.raises(ValueError, match="not a train state"):
        TC.load_checkpoint(out, state)
    state = TC.load_params_only(out, state)
    sd = state.model.state_dict()
    loss_w = [k for k in sd if k.startswith("loss.") and
              k.endswith("weight")]
    assert len(loss_w) == 1
    np.testing.assert_array_equal(sd[loss_w[0]].numpy(), centres)
    want = TP.state_dict_from_reference(R.wrapped(c["arrays"]), "ECAPA_TDNN",
                                        res2net_scale=4)
    for k, v in want.items():
        assert torch.equal(sd["backbone." + k], v), k


def test_the_engine_serves_a_converted_checkpoint(tmp_path):
    """``initial_model_infer`` naming the converter's msgpack: the engine
    (on the CPU) holds ``state_dict_from_reference``'s weights, and the
    loss head's centres are read and not restored, as in JAX."""
    from speakerverification_tpu_torch.inference import InferenceEngine

    torch.set_num_threads(2)
    c = case("ECAPA_TDNN")
    src = tmp_path / "ref.pt"
    torch.save(R.wrapped(c["arrays"], head=np.ones((6, 48), np.float32)),
               src)
    out = tmp_path / "out.msgpack"
    TP._main(_argv("ECAPA_TDNN", src, out))
    engine = InferenceEngine({**c["h"], "save_folder": str(tmp_path / "s"),
                              "initial_model_infer": str(out)},
                             device="cpu")
    assert engine.weights_path == out
    want = TP.state_dict_from_reference(R.wrapped(c["arrays"]),
                                        "ECAPA_TDNN", res2net_scale=4)
    got = engine.model.backbone.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
