"""The port's checkpoint reader and writer against the JAX package.

``checkpoint.py`` carries its own msgpack codec of flax's layout. Files
that the JAX package's ``save_checkpoint`` writes on the CPU here (a
``TrainState`` with an adam ``opt_state`` and bf16 leaves, also with
``MAX_CHUNK_SIZE`` made small so that leaves are chunked) decode as
``flax.serialization.msgpack_restore`` decodes them, and the port's
files read back in flax to the same tree, byte for byte the same file.
Weight selection, the tolerant params-only load, EMA weights and soups
agree with the JAX functions (the same trees, or the same error), and an
engine built from a JAX-written file embeds within the fp32 tolerance of
``test_torch_port_eval.py`` (``atol 1e-4 * max|ref|``).
"""

import os
import time

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from speakerverification_tpu import inference as jinference
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu.optim import track_ema
from speakerverification_tpu.training import checkpoint as jckpt
from speakerverification_tpu.training.state import TrainState
from speakerverification_tpu_torch import checkpoint as tckpt
from speakerverification_tpu_torch import inference as tinference
from speakerverification_tpu_torch.builder import encoder_from_hparams
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.weights import (
    init_weights_,
    params_from_jax,
    params_to_jax,
)

SR = 8000
ECAPA_SMALL = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
               "nOut": 16, "channels": [16, 16, 16, 16, 48],
               "kernel_sizes": [5, 3, 3, 3, 1], "dilations": [1, 2, 3, 4, 1],
               "attention_channels": 4, "res2net_scale": 2, "se_channels": 4}


def _hparams(root, **extra):
    return {"seed": 0, "num_eval": 2, "save_folder": str(root / "save"),
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "model": dict(ECAPA_SMALL),
            "criterion": {"name": "AAmSoftmax"}, "nClasses": 10,
            **extra}


def _same_tree(got, ref, path=""):
    """``got`` (the port's decoding) holds ``ref`` (flax's): the same
    keys, dtypes and values; a flax bf16 leaf is a torch bf16 tensor."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _same_tree(got[k], ref[k], f"{path}/{k}")
    elif getattr(ref, "dtype", None) is not None \
            and str(ref.dtype) == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == ref.shape, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
    else:
        assert type(got) is type(ref), (path, type(got), type(ref))
        if isinstance(ref, np.ndarray):
            assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _train_state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"backbone": {
        "Dense_0": {"kernel": jnp.asarray(rng.normal(size=(6, 5)),
                                          jnp.float32),
                    "bias": jnp.asarray(rng.normal(size=5), jnp.bfloat16)},
        "BatchNorm_0": {"scale": jnp.ones((5,), jnp.float32),
                        "bias": jnp.zeros((5,), jnp.float32)}},
        "loss": {"W": jnp.asarray(rng.normal(size=(5, 70)), jnp.float32)}}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    stats = {"backbone": {"BatchNorm_0": {
        "mean": jnp.asarray(rng.normal(size=5), jnp.float32),
        "var": jnp.ones((5,), jnp.float32)}}}
    return TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params))


@pytest.mark.parametrize("chunk", [None, 64])
def test_codec_reads_a_jax_train_state_like_flax(tmp_path, monkeypatch,
                                                 chunk):
    """adam opt_state (a chain: dicts with index keys), bf16 leaves, a
    0-d step; with ``MAX_CHUNK_SIZE`` 64 bytes the larger leaves are
    stored as chunked-array dicts and rejoined."""
    if chunk:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
    path = jckpt.save_checkpoint(tmp_path / "s.msgpack", _train_state(),
                                 {"epoch": 3})
    data = path.read_bytes()
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    ref = fser.msgpack_restore(data)
    got = tckpt.load_checkpoint(path)
    _same_tree(got, ref)
    assert set(got["opt_state"]) == {"0", "1"}
    assert tckpt.load_meta(path) == jckpt.load_meta(path) == {"epoch": 3}


@pytest.mark.parametrize("chunk", [None, 64])
def test_port_writes_what_flax_reads(tmp_path, monkeypatch, chunk):
    """The port's file of the decoded tree is flax's file, byte for
    byte, and flax reads it back to the same tree; tuples and lists are
    stored as index-keyed dicts, as flax stores them."""
    if chunk:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", chunk)
    jpath = jckpt.save_checkpoint(tmp_path / "j.msgpack", _train_state(1))
    tree = tckpt.load_checkpoint(jpath)
    path = tckpt.save_checkpoint(tmp_path / "t.msgpack", tree, {"loss": 1.5})
    assert path.read_bytes() == jpath.read_bytes()
    _same_tree(tree, fser.msgpack_restore(path.read_bytes()))
    assert jckpt.load_meta(path) == {"loss": 1.5}
    chain = {"chain": (np.float32(1.5), [np.arange(3), None])}
    back = fser.msgpack_restore(tckpt.msgpack_serialize(chain))
    assert float(back["chain"]["0"]) == 1.5 and back["chain"]["1"]["1"] is None
    np.testing.assert_array_equal(back["chain"]["1"]["0"], np.arange(3))


SCALARS = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
           2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
           -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63), 0.5, -1e300, True, False,
           None, "", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 65536,
           "é", b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
           list(range(15)), list(range(16)), list(range(65536)),
           {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
           {"nested": {"a": [1, {"b": None}]}}]


def _index_keyed(obj):
    """Lists as flax stores them: dicts with index keys."""
    if isinstance(obj, dict):
        return {k: _index_keyed(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return {str(i): _index_keyed(v) for i, v in enumerate(obj)}
    return obj


@pytest.mark.parametrize("obj", SCALARS, ids=range(len(SCALARS)))
def test_codec_matches_msgpack_on_every_type(obj):
    """Each msgpack format (fix, 8-, 16-, 32- and 64-bit forms) decodes
    as the ``msgpack`` package packs it, and encodes as it packs the same
    object with lists stored as flax stores them."""
    assert tckpt.msgpack_restore(msgpack.packb(obj, use_bin_type=True)) == obj
    assert tckpt.msgpack_serialize(obj) == msgpack.packb(
        _index_keyed(obj), use_bin_type=True)


def test_codec_ext_types_and_errors():
    for x in (np.float16(2.5), np.int64(-3), np.bool_(True), 1 + 2j,
              np.arange(6, dtype=np.uint8).reshape(2, 3)):
        data = fser.msgpack_serialize({"x": x})
        assert tckpt.msgpack_serialize({"x": x}) == data
        got, ref = tckpt.msgpack_restore(data)["x"], \
            fser.msgpack_restore(data)["x"]
        assert type(got) is type(ref)
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="ends"):
        tckpt.msgpack_restore(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="after"):
        tckpt.msgpack_restore(msgpack.packb(1) + b"\x01")
    with pytest.raises(TypeError):
        tckpt.msgpack_serialize({"x": object()})


def test_orbax_directories_are_refused_by_name(tmp_path):
    d = tmp_path / "best_state"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_checkpoint(d)


def _touch(path, age=0.0):
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".msgpack":
        path.write_bytes(b"\x80")
    else:
        path.mkdir()
    t = time.time() - age
    os.utime(path, (t, t))


LAYOUTS = {
    "best and last": ["best_state.msgpack", "last_state.msgpack"],
    "last only": ["last_state.msgpack", "model_state_000003.msgpack"],
    "epochs": ["model_state_000002.msgpack", "model_state_000010.msgpack",
               "model_state_000009"],
    "orbax best newer": ["best_state.msgpack@60", "best_state"],
    "msgpack best newer": ["best_state@60", "best_state.msgpack"],
    "initial_model_infer": ["best_state.msgpack", "!explicit.msgpack"],
    "initial_model_infer missing": ["last_state.msgpack", "!missing"],
    "empty": [],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_select_weights_matches_jax(tmp_path, layout):
    mdir = tmp_path / "model"
    mdir.mkdir()
    h = {}
    for name in LAYOUTS[layout]:
        name, _, age = name.partition("@")
        if name.startswith("!"):
            h["initial_model_infer"] = str(tmp_path / name[1:])
            if "missing" not in name:
                _touch(tmp_path / name[1:])
            continue
        _touch(mdir / name, float(age or 0))
    assert tinference._select_weights(h, mdir) == \
        jinference._select_weights(h, mdir)


@pytest.fixture(scope="module")
def jstate(tmp_path_factory):
    """A JAX engine's TrainState (small ECAPA, adam) with random weights
    and BN, and the port's template of the same model."""
    root = tmp_path_factory.mktemp("ck")
    h = _hparams(root)
    jeng = JEngine(h)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape)
        .astype(np.float32), jeng.state.params)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        jeng.state.batch_stats)
    state = jeng.state.replace(params=params, batch_stats=stats)
    model = encoder_from_hparams(h)
    init_weights_(model, torch.Generator().manual_seed(0))
    p, s = params_to_jax(model.state_dict())
    return h, state, {"params": p, "batch_stats": s}


def _backbone_equal(got, ref):
    _same_tree(got["params"]["backbone"],
               jax.tree.map(np.asarray, ref.params["backbone"]))
    _same_tree(got["batch_stats"]["backbone"],
               jax.tree.map(np.asarray, ref.batch_stats["backbone"]))


def _save_raw(path, tree):
    path.write_bytes(fser.msgpack_serialize(tree))
    return path


CASES = ["full", "bare backbone", "head with a new shape",
         "other architecture", "nothing restored"]


@pytest.mark.parametrize("case", CASES)
def test_load_params_only_matches_jax(jstate, tmp_path, case):
    """The same merged backbone, or the same error. (The port's template
    has no loss head: the checkpoint's is read and not restored.)"""
    h, state, template = jstate
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    if case == "full":
        raw = {"params": params, "batch_stats": stats}
    elif case == "bare backbone":
        raw = {"params": params["backbone"],
               "batch_stats": stats["backbone"]}
    elif case == "head with a new shape":
        # a fine-tune: the loss head's classes changed
        raw = {"params": {**params, "loss": jax.tree.map(
            lambda a: np.zeros(a.shape[:-1] + (3,), np.float32),
            params["loss"])}, "batch_stats": stats}
    elif case == "other architecture":
        raw = {"params": {"backbone": {"Foo_0": {"kernel": np.ones(3)}}}}
    else:
        raw = {"params": jax.tree.map(
            lambda a: np.zeros(a.shape[:-1] + (a.shape[-1] + 1,),
                               np.float32), params)}
    path = _save_raw(tmp_path / "c.msgpack", raw)
    try:
        ref = jckpt.load_params_only(path, state.replace(
            params=jax.tree.map(np.zeros_like, state.params)))
    except ValueError as exc:
        assert case in ("other architecture", "nothing restored")
        with pytest.raises(ValueError) as got:
            tckpt.load_params_only(path, template)
        # the same message up to the list of leaves
        assert str(got.value).split(" (first")[0] == \
            str(exc).split(" (first")[0]
        return
    assert case not in ("other architecture", "nothing restored")
    got = tckpt.load_params_only(path, template)
    _backbone_equal(got, ref)


def test_ema_weights_and_soups_match_jax(jstate, tmp_path):
    h, state, template = jstate
    rng = np.random.default_rng(9)
    tx = optax.chain(optax.adam(1e-3), track_ema(0.9))
    ema = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32), state.params)
    opt = tx.init(state.params)
    opt = (opt[0], opt[1]._replace(ema=ema))
    with_ema = jckpt.save_checkpoint(tmp_path / "ema.msgpack",
                                     state.replace(opt_state=opt))
    got = tckpt.load_ema_params(with_ema, template)
    ref = jckpt.load_ema_params(with_ema, state)
    _backbone_equal(got, ref)
    _same_tree(got["params"]["backbone"],
               jax.tree.map(np.asarray, ema["backbone"]))
    plain = jckpt.save_checkpoint(tmp_path / "plain.msgpack", state)
    assert tckpt.load_ema_params(plain, template) is None
    assert jckpt.load_ema_params(plain, state) is None

    paths = []
    for i in range(3):
        s = state.replace(params=jax.tree.map(
            lambda a: np.asarray(a) * (1 + 0.1 * i) + rng.normal(
                0, 0.01, a.shape).astype(np.float32), state.params))
        paths.append(jckpt.save_checkpoint(tmp_path / f"top{i}.msgpack", s))
    got = tckpt.average_checkpoints(paths, template)
    ref = jckpt.average_checkpoints(paths, state)
    _backbone_equal(got, ref)
    with pytest.raises(ValueError, match="no checkpoint"):
        tckpt.average_checkpoints([], template)


@pytest.mark.parametrize("name", ["ECAPA_TDNN", "Raw3_ECAPA", "Raw_ECAPA",
                                  "Raw_ECAPA_conv_asp", "Raw_ECAPA_sinc_gru",
                                  "Raw_ECAPA_hype", "RawNet2_custom",
                                  "RawNet2"])
def test_params_to_jax_round_trips_bit_for_bit(name):
    torch.set_num_threads(2)
    raw = name != "ECAPA_TDNN"
    h = {"model": {"name": name, "feature_type": "raw" if raw
                   else "melspectrogram", "nOut": 512 if raw else 192},
         "audio_spec": {"sample_rate": 8000}}
    model = encoder_from_hparams(h)
    init_weights_(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 1.5)
    sd = model.state_dict()
    params, stats = params_to_jax(sd)
    back = params_from_jax(params, stats, like=model)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # (a leaf name no port module has: ``gamma`` is one since the
    # RawNet2 family's sample LayerNorm)
    with pytest.raises(KeyError, match="no flax counterpart"):
        params_to_jax({"x.theta": torch.ones(2)})


@pytest.mark.parametrize("mode", ["best_state", "use_ema", "soup"])
def test_engine_from_a_jax_file_embeds_like_jax(jstate, tmp_path, mode):
    """The port's engine and the JAX engine pick and load the same
    JAX-written files (best_state, its EMA weights, or the top-3 soup)
    and embed within ``1e-4 * max|ref|``."""
    h, state, _ = jstate
    h = {**h, "save_folder": str(tmp_path / "save")}
    mdir = JEngine(h).dirs["model"]
    rng = np.random.default_rng(4)
    ema = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), state.params)
    tx = optax.chain(optax.adam(1e-3), track_ema(0.9))
    opt = tx.init(state.params)
    jckpt.save_checkpoint(mdir / "best_state.msgpack", state.replace(
        opt_state=(opt[0], opt[1]._replace(ema=ema))))
    for i in range(1, 4):
        jckpt.save_checkpoint(mdir / f"best_state_top{i}.msgpack",
                              state.replace(params=jax.tree.map(
                                  lambda a: np.asarray(a) * (1 + 0.05 * i),
                                  state.params)))
    h = {**h, "use_ema": mode == "use_ema",
         "average_checkpoints": mode == "soup"}
    waves = (0.2 * np.random.default_rng(5).normal(
        0, 1, (3, int(0.5 * SR)))).astype(np.float32)
    ref = np.asarray(JEngine(h).embed_fn(waves))
    engine = InferenceEngine(h, device="cpu")
    assert engine.weights_path.name == ("best_state_top1.msgpack"
                                        if mode == "soup"
                                        else "best_state.msgpack")
    got = engine.embed_fn(waves).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
