"""The port's reader of the JAX package's orbax directories
(``training/orbax_read.py``), held to the JAX package's own reads.

The JAX package saves the same state as msgpack and through
``save_sharded`` (orbax's OCDBT store). The port's read of the directory
equals its msgpack read (``checkpoint.msgpack_restore``) and JAX's own
``load_checkpoint`` / ``load_params_only`` / ``load_ema_params`` of the
directory, leaf for leaf and dtype for dtype, for

* a trainer state with AdaBelief moments, the step and an EMA of the
  weights (``optimizer.ema_decay``), restored whole by the port's
  ``training.checkpoint.load_checkpoint`` (the trainer's resume);
* a leaf sharded over 4 CPU devices (written in a subprocess with
  ``--xla_force_host_platform_device_count=4``), so that it has 4 chunks;
* the committed fixture ``tests/data/orbax_ecapa`` (orbax's own read,
  and the port's engine serving it at cosine ≥ 0.9999 to the JAX
  engine's stored embeddings, as ``chip_smoke.py``'s path P3 does on the
  GPU).

A multi-level OCDBT b-tree (TensorStore with small nodes) reads key for
key; a directory of neither format, a zarr v3 store, an unread dtype and
a missing chunk raise, each by name.
"""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from speakerverification_tpu.training import checkpoint as jckpt
from speakerverification_tpu.training.checkpoint_sharded import (
    save_sharded as j_save_sharded,
)
from speakerverification_tpu_torch import checkpoint as codec
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.training import orbax_read as O
from test_torch_port_train_helpers import Pair, batches

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax_ecapa"
SR = 8000
SMALL = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram", "nOut": 16,
         "channels": [16, 16, 16, 16, 48], "kernel_sizes": [5, 3, 3, 3, 1],
         "dilations": [1, 2, 3, 4, 1], "attention_channels": 4,
         "res2net_scale": 2, "se_channels": 4}


def _hparams(root):
    return {"seed": 3, "save_folder": str(root / "save"),
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "model": dict(SMALL), "nClasses": 6, "lr": 0.003,
            "criterion": {"name": "ARmSoftmax", "margin": 0.2, "scale": 30},
            "optimizer": {"name": "AdaBelief", "weight_decay": 2e-5,
                          "lr_decay": 0.95, "ema_decay": 0.99}}


def leaves(tree, prefix=""):
    """Flat ``{path: leaf}``; an empty dict is a leaf of its own."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict) and v:
            out.update(leaves(v, path))
        else:
            out[path] = v
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def same(got, want):
    """The same leaves, dtypes and values (a bf16 leaf as a torch bf16
    tensor in both)."""
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))[:5]
    for k in w:
        if isinstance(w[k], dict):
            assert g[k] == w[k] == {}, k
            continue
        assert type(g[k]) is type(w[k]) or (
            isinstance(g[k], np.ndarray) and isinstance(w[k], np.ndarray)), k
        if isinstance(w[k], torch.Tensor):
            assert g[k].dtype == w[k].dtype, k
        else:
            assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX trainer state (small ECAPA + ARmSoftmax, AdaBelief with an
    EMA; moments moved off zero, step 37, one bf16 leaf) saved both ways,
    and the port's template of the same model."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("orbax")
    h = _hparams(root)
    pair = Pair(h, batches(np.random.default_rng(0), 1, 3, 2, 4000, 6)[0])
    rng = np.random.default_rng(1)

    def moved(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            return jnp.asarray(a)
        return jnp.asarray(a + rng.normal(0, 0.1, a.shape).astype(a.dtype))

    state = pair.jstate.replace(
        step=jnp.asarray(37, jnp.int32),
        params=jax.tree.map(moved, pair.jstate.params),
        opt_state=jax.tree.map(moved, pair.jstate.opt_state))
    tree = {"state": state, "extra": {"bf16": jnp.arange(6).astype(
        jnp.bfloat16), "i64": np.arange(5, dtype=np.int64),
        "flag": jnp.asarray([True, False])}}
    jckpt.save_checkpoint(root / "state.msgpack", state)
    j_save_sharded(root / "state", state)
    j_save_sharded(root / "tree", tree)
    (root / "tree.msgpack").write_bytes(fser.to_bytes(tree))
    return dict(root=root, h=h, pair=pair, state=state)


def test_trainer_state_reads_as_its_msgpack(saved):
    root = saved["root"]
    got = O.read_orbax(root / "state")
    same(got, codec.msgpack_restore((root / "state.msgpack").read_bytes()))
    assert int(got["step"]) == 37
    assert set(got["opt_state"]) == {"0", "1"}          # the chain
    # and as the JAX package restores the directory itself
    restored = jckpt.load_checkpoint(root / "state", saved["state"])
    same(got, codec.msgpack_restore(fser.to_bytes(restored)))


def test_dtypes_read_as_msgpack_gives_them(saved):
    root = saved["root"]
    got = O.read_orbax(root / "tree")
    same(got, codec.msgpack_restore((root / "tree.msgpack").read_bytes()))
    assert got["extra"]["bf16"].dtype == torch.bfloat16
    assert got["extra"]["flag"].dtype == np.bool_


def test_the_port_s_loaders_read_the_directory_as_jax_s(saved):
    """``load_checkpoint`` (the trainer's resume: the whole state into the
    port's template), ``load_params_only`` and ``load_ema_params`` read
    the directory as the msgpack file, and as JAX reads the directory."""
    root, pair = saved["root"], saved["pair"]
    d, f = root / "state", root / "state.msgpack"

    def as_read(state):        # the port's state as a checkpoint reads
        return codec.msgpack_restore(codec.msgpack_serialize(
            tckpt.state_to_jax(state)))

    a = as_read(tckpt.load_checkpoint(d, pair.tstate))
    assert int(a["step"]) == 37
    same(a, codec.msgpack_restore(f.read_bytes()))
    same(as_read(tckpt.load_checkpoint(f, pair.tstate)), a)

    template = pair.load_jax_state(root)       # any state of the model
    tmpl = {"params": tckpt.state_to_jax(template)["params"],
            "batch_stats": tckpt.state_to_jax(template)["batch_stats"]}
    got = codec.load_params_only(d, tmpl)
    same(got, codec.load_params_only(f, tmpl))
    jgot = jckpt.load_params_only(d, saved["state"])
    same(got, {"params": jax.tree.map(np.asarray, jgot.params),
               "batch_stats": jax.tree.map(np.asarray, jgot.batch_stats)})

    ema = codec.load_ema_params(d, tmpl)
    same(ema, codec.load_ema_params(f, tmpl))
    jema = jckpt.load_ema_params(d, saved["state"])
    same(ema, {"params": jax.tree.map(np.asarray, jema.params),
               "batch_stats": jax.tree.map(np.asarray, jema.batch_stats)})
    assert not np.array_equal(ema["params"]["backbone"]["Dense_0"]["kernel"],
                              got["params"]["backbone"]["Dense_0"]["kernel"])


def test_params_only_and_ema_reads_leave_the_rest_unread(saved,
                                                         monkeypatch):
    read = []
    real = O._read_zarr
    monkeypatch.setattr(O, "_read_zarr",
                        lambda store, name: read.append(name) or
                        real(store, name))
    codec.load_checkpoint(saved["root"] / "state", params_only=True)
    assert read and all(n.split(".")[0] in ("params", "batch_stats")
                        for n in read)
    read.clear()
    codec.load_checkpoint(saved["root"] / "state", ema=True)
    assert read and all(n.startswith("batch_stats.") or ".ema." in n
                        for n in read)


SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    sys.path.insert(0, {root!r})
    from speakerverification_tpu.training.checkpoint_sharded import (
        save_sharded)
    assert len(jax.devices()) == 4
    mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("model", "data"))
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4000, 48)).astype(np.float32)
    state = {{"params": {{"loss": {{"weight": jax.device_put(
                 w, NamedSharding(mesh, P("model", None)))}},
              "backbone": {{"b": jax.device_put(
                 jnp.arange(6.0), NamedSharding(mesh, P()))}}}},
              "step": jnp.asarray(3, jnp.int32)}}
    save_sharded({out!r}, state)
    np.save({out!r} + ".npy", w)
""")


def test_a_leaf_sharded_over_four_devices_reads_whole(tmp_path):
    out = str(tmp_path / "sharded")
    subprocess.run([sys.executable, "-c",
                    SHARDED.format(root=str(ROOT), out=out)],
                   check=True, capture_output=True, timeout=300)
    store = O.OcdbtStore(out)
    chunks = [k for k in store.keys()
              if k.startswith(b"params.loss.weight/") and b".zarray" not in k]
    store.close()
    assert sorted(chunks) == [b"params.loss.weight/%d.0" % i
                              for i in range(4)]
    got = O.read_orbax(out)
    np.testing.assert_array_equal(got["params"]["loss"]["weight"],
                                  np.load(out + ".npy"))
    np.testing.assert_array_equal(got["params"]["backbone"]["b"],
                                  np.arange(6.0, dtype=np.float32))
    assert int(got["step"]) == 3


def _fixture():
    fx = json.loads((FIXTURE / "fixture.json").read_text())
    rng = np.random.default_rng(fx["wave_seed"])
    waves = (0.1 * rng.standard_normal(fx["wave_shape"])).astype(np.float32)
    return fx, waves


def test_the_committed_fixture_reads_as_orbax_reads_it():
    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    try:
        want = ckpt.restore(FIXTURE.joinpath("state").resolve())
    finally:
        ckpt.close()
    got = O.read_orbax(FIXTURE / "state")

    def empty_as_map(node):     # orbax gives an optax EmptyState as None
        if isinstance(node, dict):
            return {k: empty_as_map(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [empty_as_map(v) for v in node]
        return {} if node is None else node

    same(got, codec.msgpack_restore(fser.to_bytes(empty_as_map(want))))
    assert int(got["step"]) == _fixture()[0]["step"]


def test_the_port_serves_the_fixture_as_jax_did(tmp_path):
    """P3 of ``chip_smoke.py`` on the CPU: the engine's
    ``initial_model_infer`` is the orbax directory; the embeddings of the
    8 seeded waves are at cosine ≥ 0.9999 to the JAX engine's."""
    torch.set_num_threads(2)
    fx, waves = _fixture()
    h = read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    h = {**h, "save_folder": str(tmp_path / "save"), "seed": fx["seed"],
         "initial_model_infer": str(FIXTURE / "state"),
         "model": {**fx["model"], "feature_type": "melspectrogram",
                   "conv_backend": "pallas"}}
    eng = InferenceEngine(h, device="cpu")
    assert eng.weights_path == FIXTURE / "state"
    got = eng.embed_fn(waves).numpy()
    ref = np.load(FIXTURE / "embeddings.npy")
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) \
        / np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.9999, cos


def test_a_multi_level_btree_reads_key_for_key(tmp_path):
    import tensorstore as ts

    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/store/",
        "config": {"max_decoded_node_bytes": 300,
                   "max_inline_value_bytes": 16,
                   "compression": {"id": "zstd"}}}).result()
    rng = np.random.default_rng(0)
    want = {}
    for i in range(90):
        key = f"params.block_{i:03d}.conv/{'.zarray' if i % 3 else '0.0'}"
        want[key.encode()] = rng.bytes(int(rng.integers(1, 50)))
        kv.write(key, want[key.encode()]).result()
    store = O.OcdbtStore(tmp_path / "store")
    assert store.keys() == sorted(want)
    for k, v in want.items():
        assert store[k] == v
    store.close()


def _metadata(path, entries, **flags):
    md = {"tree_metadata": {
        str(tuple(keys)): {"key_metadata": [{"key": k, "key_type": 2}
                                            for k in keys],
                           "value_metadata": {"value_type": "jax.Array",
                                              "write_shape": []}}
        for keys in entries}, "use_ocdbt": True, "use_zarr3": False}
    md.update(flags)
    (path / "_METADATA").write_text(json.dumps(md))


def _zarr_store(path, zarray: dict, chunks: dict):
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    kv.write("x/.zarray", json.dumps(zarray)).result()
    for k, v in chunks.items():
        kv.write(f"x/{k}", v).result()


def test_what_is_not_read_is_refused_by_name(tmp_path, saved):
    import zstandard

    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        (tmp_path / "neither").mkdir()
        codec.load_checkpoint(tmp_path / "neither")

    v3 = tmp_path / "v3"
    shutil.copytree(saved["root"] / "state", v3)
    md = json.loads((v3 / "_METADATA").read_text())
    (v3 / "_METADATA").write_text(json.dumps({**md, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr v2"):
        codec.load_checkpoint(v3)

    zarray = {"chunks": [2], "compressor": {"id": "zstd", "level": 1},
              "dimension_separator": ".", "dtype": "<f4",
              "fill_value": None, "filters": None, "order": "C",
              "shape": [4], "zarr_format": 2}
    z = zstandard.ZstdCompressor()
    half = z.compress(np.ones(2, np.float32).tobytes())
    for name, za, chunks, match in (
            ("missing", zarray, {"0": half}, "chunk 'x/1' is missing"),
            ("complex", {**zarray, "dtype": "<c8"}, {"0": half, "1": half},
             "dtype '<c8'"),
            ("whole", zarray, {"0": half, "1": half}, None)):
        d = tmp_path / name
        d.mkdir()
        _zarr_store(d, za, chunks)
        _metadata(d, [("x",)])
        if match is None:
            np.testing.assert_array_equal(O.read_orbax(d)["x"], np.ones(4))
        else:
            with pytest.raises(ValueError, match=match):
                O.read_orbax(d)


def test_the_reader_needs_the_native_decoder(monkeypatch):
    """No compiler, no read: the error names the decoder."""
    from speakerverification_tpu_torch.ops import _build

    def fail(name, signatures):
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                           f"native/{name}.cpp")

    monkeypatch.setattr(O, "_lib", None)
    monkeypatch.setattr(_build, "load_host", fail)
    with pytest.raises(RuntimeError, match=r"zstd decoder \(native/zstd"):
        O.zstd_decompress(b"\x28\xb5\x2f\xfd")
