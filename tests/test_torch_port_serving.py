"""Port inference and serving against the JAX package.

``InferenceEngine(hparams, device="cpu")`` against JAX
``make_eval_embed_fn`` on the same weights (float32 and int16
transport), the HTTP app's ``/embed`` and ``/score`` against the JAX
embeddings, the CUDA default of the entry points (engine, server, the
``inference`` verb and the CLI), and the port's config reader against
the JAX one.

Tolerance: embeddings are L2-normalized; 1e-4 absolute per component
(fp32 on both sides, ~20 layers of sums in different orders).
"""

import http.client
import importlib.util
import json
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import config as jconfig
from speakerverification_tpu import serving as jserving
from speakerverification_tpu.builder import encoder_from_hparams as j_encoder
from speakerverification_tpu.training.train_step import make_eval_embed_fn
from speakerverification_tpu_torch import config as tconfig
from speakerverification_tpu_torch import serving as tserving
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.weights import params_from_jax

from test_torch_port_helpers import randomized_variables

ROOT = Path(__file__).resolve().parents[1]
SR, SENTENCE, NUM_EVAL = 8000, 0.5, 2
TOL = 1e-4


def _hparams(**extra):
    h = {
        "seed": 0,
        "num_eval": NUM_EVAL,
        "audio_spec": {"sample_rate": SR, "channels": 1,
                       "sentence_len": SENTENCE,
                       "win_len": 0.025, "hop_len": 0.01},
        "n_mels": 40,
        "features": "melspectrogram",
        "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                  "nOut": 16, "channels": [16, 16, 16, 16, 48],
                  "kernel_sizes": [5, 3, 3, 3, 1],
                  "dilations": [1, 2, 3, 4, 1],
                  "attention_channels": 4, "res2net_scale": 2,
                  "se_channels": 4},
        "serving": {"batch_utts": 2, "max_wait_ms": 5},
    }
    h.update(extra)
    return h


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """hparams, JAX eval embed fn, port weights file and the flax
    variables they hold."""
    h = _hparams()
    model = j_encoder(h, with_loss=False, num_devices=1)
    T = int(SR * SENTENCE)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, T)))
    v = randomized_variables(v, seed=5)
    path = tmp_path_factory.mktemp("w") / "port.pt"
    torch.save(params_from_jax(v["params"], v["batch_stats"]), path)
    embed = make_eval_embed_fn(model)

    def jax_embed(wave):
        return np.asarray(embed(v["params"], v["batch_stats"],
                                jnp.asarray(wave)))

    return SimpleNamespace(h=h, jax_embed=jax_embed, path=path,
                           variables=v)


def _waves(n, seed=0):
    T = int(SR * SENTENCE)
    return (0.2 * np.random.default_rng(seed).normal(0, 1, (n, T))
            ).astype(np.float32)


@pytest.mark.parametrize("transport", ["float32", "int16"])
def test_engine_matches_jax_eval_embed(pair, transport):
    h, jax_embed, path = pair.h, pair.jax_embed, pair.path
    engine = InferenceEngine({**h, "eval_transport": transport},
                             weights=str(path), device="cpu")
    wave = _waves(3, seed=1)
    got = engine.embed_fn(wave)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    ref_in = wave if transport == "float32" else np.clip(
        np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
    ref = jax_embed(ref_in)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_engine_mixed_precision_close_to_jax(pair):
    """``mixedprec: true`` casts the parameters (not the BN statistics)
    to bf16 on both sides. The two frameworks round at other points, so
    this compares directions: cosine >= 0.9999 per row."""
    h, path = {**pair.h, "mixedprec": True}, pair.path
    model = j_encoder(h, with_loss=False, num_devices=1)
    v = pair.variables
    embed = make_eval_embed_fn(model, compute_dtype=jnp.bfloat16)
    wave = _waves(3, seed=2)
    ref = np.asarray(embed(v["params"], v["batch_stats"], jnp.asarray(wave)))
    got = InferenceEngine(h, weights=str(path), device="cpu").embed_fn(wave)
    assert np.all(np.sum(got.numpy() * ref, axis=1) >= 0.9999)


def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_serving_app_embed_and_score(pair, tmp_path):
    h, jax_embed, path = pair.h, pair.jax_embed, pair.path
    h = {**h, "save_folder": str(tmp_path / "save")}
    engine = InferenceEngine(h, weights=str(path), device="cpu")
    handler, batcher = tserving.make_serving_app(engine, h)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    rng = np.random.default_rng(7)
    pcm = [(0.3 * rng.normal(0, 1, int(SR * 0.8))).astype(np.float32)
           for _ in range(2)]

    def jax_crops(x):
        crops = jserving._decode_audio_spec({"pcm": x.tolist()},
                                            h["audio_spec"], NUM_EVAL)
        # the app's default transport is int16
        return jax_embed(np.clip(np.round(crops * 32768.0),
                                 -32768, 32767).astype(np.int16))

    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["status"] == "ok" and health["transport"] == "int16"
        for x in pcm:
            status, out = _post(port, "/embed", {"pcm": x.tolist(),
                                                 "sample_rate": SR})
            assert status == 200 and out["dim"] == 16
            ref = jserving._utt_embedding(jax_crops(x))
            np.testing.assert_allclose(out["embedding"], ref, atol=TOL)
        status, out = _post(port, "/score", {"enroll": {"pcm": pcm[0].tolist()},
                                             "test": {"pcm": pcm[1].tolist()}})
        assert status == 200
        ref = jserving._pair_cosine(jax_crops(pcm[0]), jax_crops(pcm[1]))
        assert out["score"] == pytest.approx(ref, abs=TOL)
        # no --prepare artifacts yet: the bank routes answer 400 and name
        # them (tests/test_torch_port_bank.py drives the banks)
        status, out = _post(port, "/identify", {"pcm": pcm[0].tolist()})
        assert status == 400 and "embeds.npy" in out["error"]
        status, out = _post(port, "/embed", {"pcm": [0.1], "sample_rate": 16000})
        assert status == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()


def test_batcher_pads_with_request_zero():
    """A lone request reaches ``embed`` at its own rows: nothing pads the
    batch up to ``batch_utts``."""
    seen = []

    def fake(waves):
        seen.append(np.array(waves))
        return torch.from_numpy(np.asarray(waves, np.float32)[:, :4])

    b = tserving.DynamicBatcher(fake, batch_utts=3, num_eval=2, samples=6,
                                max_wait_ms=1, transport="float32")
    try:
        crops = np.arange(12, dtype=np.float32).reshape(2, 6)
        out = b.submit(crops).result(timeout=10)
        np.testing.assert_array_equal(out, crops[:, :4])
        assert len(seen) == 1 and seen[0].shape == (2, 6)
        np.testing.assert_array_equal(seen[0], crops)
        assert (b.batches_run, b.utts_served, b.rows_run) == (1, 1, 2)
    finally:
        b.close()


class _FakeEmbed:
    """Deterministic extractor returning a tensor, as the engine does:
    row i -> normalized first 8 samples (+0.01)."""

    def __init__(self):
        self.calls, self.lock = [], threading.Lock()

    def __call__(self, waves):
        w = np.asarray(waves)
        with self.lock:
            self.calls.append((w.shape, w.dtype))
        if w.dtype == np.int16:
            w = w.astype(np.float32) / 32768.0
        e = w[:, :8].astype(np.float32) + 0.01
        return torch.from_numpy(e / np.linalg.norm(e, axis=1, keepdims=True))


def _crops(seed, shape=(2, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_batcher_coalesces_into_fixed_shape_batches():
    """Seven concurrent requests under ``batch_utts=4`` come as one batch
    of four and one of three, each at the rows it carries."""
    from concurrent.futures import ThreadPoolExecutor
    fake = _FakeEmbed()
    b = tserving.DynamicBatcher(fake, batch_utts=4, num_eval=2, samples=64,
                                max_wait_ms=200, transport="float32")
    try:
        crops = [_crops(i) for i in range(7)]
        with ThreadPoolExecutor(8) as ex:
            futs = list(ex.map(b.submit, crops))
        results = [f.result(timeout=10) for f in futs]
        assert sorted(c[0] for c in fake.calls) == [(6, 64), (8, 64)]
        assert len(fake.calls) == 2 and b.utts_served == 7
        assert b.rows_run == b.utts_served * b.num_eval == 14
        for c, r in zip(crops, results):
            np.testing.assert_allclose(r, fake(c).numpy(), rtol=1e-6)
    finally:
        b.close()


@pytest.mark.parametrize("transport", ["int16", "float32"])
def test_warm_up_runs_every_batch_size(transport):
    """``warm_up`` sends the engine one batch of each size the batcher
    can send, ``batch_utts`` requests down to one, in its wire format."""
    sent = []
    engine = SimpleNamespace(warm_up=lambda w: sent.append((w.shape,
                                                           w.dtype)))
    b = tserving.DynamicBatcher(_FakeEmbed(), batch_utts=3, num_eval=2,
                                samples=64, transport=transport)
    try:
        tserving.warm_up(engine, b)
    finally:
        b.close()
    dtype = np.int16 if transport == "int16" else np.float32
    assert sent == [((6, 64), dtype), ((4, 64), dtype), ((2, 64), dtype)]


def test_batcher_int16_wire_errors_and_close():
    fake = _FakeEmbed()
    b = tserving.DynamicBatcher(fake, batch_utts=1, num_eval=2, samples=64,
                                max_wait_ms=5, transport="int16")
    try:
        crops = np.clip(_crops(0), -1.5, 1.5)
        b.submit(crops).result(timeout=10)
        assert fake.calls == [((2, 64), np.int16)]
        with pytest.raises(ValueError):
            b.submit(np.zeros((3, 64), np.float32))
    finally:
        b.close()
    with pytest.raises(RuntimeError):
        b.submit(crops)                                   # closed
    with pytest.raises(ValueError, match="transport"):
        tserving.DynamicBatcher(fake, 1, 2, 64, transport="int8")

    def boom(w):
        raise RuntimeError("device on fire")

    bb = tserving.DynamicBatcher(boom, 1, 2, 64, max_wait_ms=5)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            bb.submit(_crops(1)).result(timeout=10)
    finally:
        bb.close()


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from speakerverification_tpu_torch.cli.main import main as cli_main
    from speakerverification_tpu_torch.inference import inference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(_hparams())
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(_hparams(quant="int8"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.make_serving_app(None, _hparams())
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.serve(_hparams(), port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference(_hparams(evaluation_file="unused.txt"), eval_=True)
    for verb in ({"prepare": True}, {"test": True}, {"predict": ["a.wav"]}):
        with pytest.raises(RuntimeError, match="CUDA"):
            inference(_hparams(save_folder=str(tmp_path / "save")), **verb)
    from speakerverification_tpu_torch.evaluation.bank import SpeakerBank
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeakerBank(np.eye(3, dtype=np.float32))
    cfg = tmp_path / "config.yaml"
    # JSON is YAML; the CLI freezes the config into the run's directories
    cfg.write_text(json.dumps(_hparams(save_folder=str(tmp_path / "save"))))
    for verb in ("--do_infer --eval", "--do_infer --prepare",
                 "--do_infer --test", "--do_infer --predict a.wav",
                 "--do_serve"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main([*verb.split(), "--config", str(cfg), "--quant", "int8"])


@pytest.mark.parametrize("name", ["raw3_ecapa.yaml", "ecapa_tdnn.yaml"])
def test_read_config_matches_jax(name):
    path = ROOT / "yaml" / name
    assert tconfig.read_config(path) == jconfig.read_config(path)
    args = {"num_eval": 3}
    assert tconfig.read_config(path, args, {"seed": 1}) == \
        jconfig.read_config(path, args, {"seed": 1})


def _subset_of(sub, full, where=""):
    for k, v in sub.items():
        assert k in full, f"{where}{k} is not in the yaml"
        if isinstance(v, dict):
            _subset_of(v, full[k], f"{where}{k}.")
        else:
            assert v == full[k], f"{where}{k}: {v!r} != {full[k]!r}"


def test_chip_smoke_hparams_mirror_the_yaml():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, h in (("raw3_ecapa.yaml", smoke.RAW3_ECAPA_HPARAMS),
                    ("raw3_ecapa.yaml", smoke.RAW3_TRAIN_HPARAMS),
                    ("ecapa_tdnn.yaml", smoke.ECAPA_TDNN_HPARAMS)):
        _subset_of(h, jconfig.read_config(ROOT / "yaml" / name), f"{name}: ")
    _subset_of(smoke.RAW_ECAPA_HPARAMS,
               jconfig.read_config(ROOT / "yaml" / "voxceleb_raw_ecapa.yaml"),
               "voxceleb_raw_ecapa.yaml: ")
    # path F3: each variant has the keys of the yaml that names it; the
    # builders no yaml names take voxceleb_raw_ecapa.yaml's keys
    named = {}
    for name, h in smoke.F3_VARIANTS:
        full = jconfig.read_config(ROOT / "yaml" / name)
        named[h["model"]["name"]] = full["model"]["name"]
        full["model"] = {**full["model"], "name": h["model"]["name"]}
        _subset_of(h, full, f"{name}: ")
    assert named == {"Raw_ECAPA": "Raw_ECAPA",
                     "Raw_ECAPA_sinc_gru": "Raw_ECAPA_sinc_gru",
                     "RawNet2_custom": "RawNet2_custom",
                     "Raw_ECAPA_sinc_asp": "Raw_ECAPA_conv_asp",
                     "Raw_ECAPA_hype": "Raw_ECAPA_conv_asp",
                     "RawNet2": "Raw_ECAPA_conv_asp"}
