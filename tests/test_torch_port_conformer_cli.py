"""``yaml/model_plot.yaml`` (``Conformer`` + AAmSoftmaxAP + AdaBelief)
through the port's CLI on the CPU: ``--do_train`` on synthetic WAVs
(dropout drawn from the Trainer's generator), ``--do_infer --eval`` of
the checkpoint it wrote, and ``--do_serve`` answering ``/embed`` and
``/score``; the JAX package's engine reads the same checkpoint and
embeds within 1e-4 of the largest magnitude. The yaml's keys are kept
but for the widths (encoder dim 32, one block), the crop (0.5 s), the
batch and the paths.

Also: ``chip_smoke.py``'s Conformer hparams mirror the yaml, and its
table of K3's Dense shapes (path I3) is what the two full-width models
quantize at the default floors.
"""

import http.client
import importlib.util
import json
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from speakerverification_tpu import config as jconfig
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch import serving as tserving
from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.data.audio import load_wav, write_wav
from speakerverification_tpu_torch.data.manifest import Manifest
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.quant import QuantConfig, quantizable

ROOT = Path(__file__).resolve().parents[1]
SR = 16000


def _corpus(root, n_spk: int = 6, n_utt: int = 4) -> dict:
    rng = np.random.default_rng(0)
    files = {}
    tt = np.arange(int(1.0 * SR)) / SR
    for spk in range(n_spk):
        for utt in range(n_utt):
            sig = (0.25 * np.sin(2 * np.pi * (120 + 60 * spk) * tt
                                 + rng.uniform(0, 6))
                   + rng.normal(0, 0.01, tt.size))
            path = root / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), SR)
            files.setdefault(spk, []).append(str(path))
    # the training manifest over every file (the yaml's split_ratio -1
    # would keep one file a speaker for training)
    Manifest.write(root / "meta" / "train.csv",
                   [[f"spk{s}", p, 1.0, "wav"] for s in files
                    for p in files[s]])
    return files


def _config(root, trials) -> dict:
    h = read_config(ROOT / "yaml" / "model_plot.yaml")
    h = {**h, "save_folder": str(root / "save"),
         "data_folder": str(root / "data"),
         "train_annotation": str(root / "meta" / "train.csv"),
         "evaluation_file": str(trials), "number_of_epochs": 1,
         "batch_size": 3, "num_eval": 2, "nClasses": 6,
         "audio_spec": {**h["audio_spec"], "sentence_len": 0.5},
         "model": {**h["model"], "encoder_dim": 32, "num_layers": 1},
         "dataloader_options": {**h["dataloader_options"], "batch_size": 3,
                                "num_workers": 2},
         "serving": {"batch_utts": 2, "max_wait_ms": 5}}
    for key in ("output_folder", "noise_folder", "verification_file",
                "pretrained", "cohorts_path"):
        h.pop(key, None)
    return h


def _get(port, method, path, obj=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if obj is None
                     else json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_model_plot_trains_evaluates_and_serves(tmp_path, capsys,
                                                monkeypatch):
    torch.set_num_threads(2)
    files = _corpus(tmp_path)
    trials = tmp_path / "trials.txt"
    trials.write_text("".join(f"{int(a == b)} {files[a][0]} {files[b][1]}\n"
                              for a in files for b in files))
    h = _config(tmp_path, trials)
    cfg = tmp_path / "model_plot.yaml"
    cfg.write_text(json.dumps(h))
    assert cli_main(["--do_train", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[DONE] min_loss" in out
    run = tmp_path / "save" / "Conformer" / "AAmSoftmaxAP"
    for name in ("best_state.msgpack", "last_state.msgpack"):
        assert (run / "model" / name).exists(), name
    assert cli_main(["--do_infer", "--eval", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    assert "loaded weights" in capsys.readouterr().out
    rows = (run / "result" / "evaluation_results.csv").read_text()
    assert len(rows.strip().splitlines()) == 36 + 1

    # the JAX engine reads the port's checkpoint and embeds alike
    crops = np.concatenate([load_wav(files[s][2], h["audio_spec"],
                                     num_eval=2) for s in (0, 1)])
    ref = np.asarray(JEngine(h).embed_fn(crops))
    got = InferenceEngine(h, device="cpu").embed_fn(crops).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())

    # --do_serve, its server stopped from here
    servers = []

    class Recorded(ThreadingHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    monkeypatch.setattr(tserving, "ThreadingHTTPServer", Recorded)
    serve = threading.Thread(target=cli_main, args=(
        ["--do_serve", "--config", str(cfg), "--device", "cpu",
         "--serve_host", "127.0.0.1", "--serve_port", "0"],), daemon=True)
    serve.start()
    deadline = time.time() + 120
    while not servers and time.time() < deadline:
        time.sleep(0.05)
    assert servers, "the server did not start"
    port = servers[0].server_address[1]
    try:
        status, health = _get(port, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        tt = np.arange(int(0.8 * SR)) / SR
        pcm = [(0.3 * np.sin(2 * np.pi * f0 * tt)).tolist()
               for f0 in (150.0, 330.0)]
        status, emb = _get(port, "POST", "/embed", {"pcm": pcm[0],
                                                    "sample_rate": SR})
        assert status == 200 and emb["dim"] == 512
        assert abs(np.linalg.norm(emb["embedding"]) - 1) < 1e-4
        status, score = _get(port, "POST", "/score", {
            "enroll": {"pcm": pcm[0]}, "test": {"pcm": pcm[1]}})
        assert status == 200 and np.isfinite(score["score"])
    finally:
        servers[0].shutdown()
        serve.join(timeout=60)
    assert not serve.is_alive()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _subset_of(sub, full, where=""):
    for k, v in sub.items():
        assert k in full, f"{where}{k} is not in the yaml"
        if isinstance(v, dict):
            _subset_of(v, full[k], f"{where}{k}.")
        else:
            assert v == full[k], f"{where}{k}: {v!r} != {full[k]!r}"


def test_chip_smoke_conformer_hparams_mirror_the_yaml():
    _subset_of(_chip_smoke().CONFORMER_HPARAMS,
               jconfig.read_config(ROOT / "yaml" / "model_plot.yaml"),
               "model_plot.yaml: ")


@pytest.mark.parametrize("name", ["Conformer", "ECAPA_Conformer"])
def test_chip_smoke_dense_shapes_are_what_the_models_quantize(name):
    """(K, N) of every Dense the default floors quantize, with its count,
    against path I3's table (160 crops of 2 s at 16 kHz: 201 frames, 49
    after the subsampling, M = 160 · 49 rows)."""
    model = TB.build_model(name, n_mels=80)
    cfg = QuantConfig()
    got = {}
    for m in model.modules():
        if isinstance(m, torch.nn.Linear) and quantizable(m, cfg):
            key = (m.in_features, m.out_features)
            got[key] = got.get(key, 0) + 1
    want = {}
    for x_shape, n, per_fwd, layer in _chip_smoke().CONFORMER_DENSE_SHAPES:
        if layer.startswith(name + " "):
            assert x_shape[0] in (160, 160 * 49)
            want[(x_shape[1], n)] = per_fwd
    assert got == want


def test_chip_smoke_path_i_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py``'s path I driven on the CPU at a small size, so that
    its code runs before a chip call does: Conformer at encoder dim 128
    (one block: three int8 Denses), ECAPA_Conformer at 16 channels, 0.5 s
    crops, 2 crops per utterance, 4 speakers × 2 crops per step, a corpus
    of 8 speakers; K1's and K3's plain versions counted as their
    launches, host clocks for CUDA events, no profiles; K3's table at
    these widths."""
    torch.set_num_threads(4)
    smoke = _chip_smoke()
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    from speakerverification_tpu_torch.ops import quant_matmul as tqm
    from test_torch_port_train_smoke import _patch_for_cpu
    _patch_for_cpu(smoke, tmf, monkeypatch, n_spk=8)
    plain = tqm.quant_matmul_plain

    def counted(*args, **kwargs):
        tqm.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tqm, "quant_matmul_plain", counted)
    batch = smoke.seeded_batch
    monkeypatch.setattr(smoke, "seeded_batch",
                        lambda seed, n_spk, n_per, h:
                        batch(seed, min(n_spk, 4), n_per, h))

    def shrink(h, **model):
        return {**h, "num_eval": 2, "batch_size": 4, "nClasses": 300,
                "frontend_backend": "pallas",
                "audio_spec": {**h["audio_spec"], "sentence_len": 0.5},
                "dataloader_options": {**h["dataloader_options"],
                                       "batch_size": 4, "num_workers": 2},
                "model": {**h["model"], **model}}

    monkeypatch.setattr(smoke, "CONFORMER_HPARAMS", shrink(
        smoke.CONFORMER_HPARAMS, nOut=64, encoder_dim=128, num_layers=1))
    monkeypatch.setattr(smoke, "ECAPA_CONFORMER_HPARAMS", shrink(
        smoke.ECAPA_CONFORMER_HPARAMS, channels=[16, 16, 16, 16, 48],
        encoder_dim=16, num_layers=1))
    # 16 served crops of 51 frames: 12 after the subsampling
    monkeypatch.setattr(smoke, "CONFORMER_DENSE_SHAPES", [
        ((192, 512), 128, 2, "Conformer _FeedForward_0/1 Dense_1"),
        ((192, 2432), 128, 1, "Conformer subsampling Dense_0"),
        ((192, 576), 144, 1, "ECAPA_Conformer (a shape)")])
    out = smoke.path_i(tmp_path, "CPU", "cpu", torch.Generator())
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[I1]", "[I2] int8 on the card vs", "[I3 Conformer",
                "[I4 gradient]", "[I4 step 2]", "[I4 fp32 dropout]",
                "[I5]", "[I6] --do_infer --eval"):
        assert tag in log, tag
    assert out["counts"]["quant_matmul"] == 3
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 1
