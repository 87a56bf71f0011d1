"""The zoo through the port's CLI on the CPU, and ``chip_smoke.py``'s path J.

* ``yaml/ecapa_tdnn.yaml``'s keys with ``model.name: ResNetSE34V2``
  (crops cut to 0.5 s, a small batch and corpus): ``--do_train`` on
  synthetic WAVs, ``--do_infer --eval`` of the checkpoint it wrote in
  fp32, bf16 (``mixedprec``) and int8 (``--quant int8``), ``--prepare``
  (embed) and ``--do_serve`` answering ``/embed``; the JAX package's
  engine reads the same checkpoint and embeds within 1e-4 of the largest
  magnitude.
* ``chip_smoke.py``'s path J hparams mirror the yaml; its table of K3's
  new shapes (J2) is what ResNetSE34V2 and Raw_ECAPA_conv_asp quantize
  in one int8 forward of a 2 s crop; path J runs on the CPU at a small
  size before a chip call does.
"""

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
from speakerverification_tpu_torch import serving as tserving
from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.data.audio import load_wav
from speakerverification_tpu_torch.inference import InferenceEngine

from test_torch_port_conformer_cli import _corpus, _get

ROOT = Path(__file__).resolve().parents[1]
SR = 16000


def _config(root, trials) -> dict:
    h = jconfig.read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    h = {**h, "save_folder": str(root / "save"),
         "data_folder": str(root / "data"),
         "train_annotation": str(root / "meta" / "train.csv"),
         "evaluation_file": str(trials), "number_of_epochs": 1,
         "batch_size": 3, "num_eval": 2, "nClasses": 6,
         "audio_spec": {**h["audio_spec"], "sentence_len": 0.5},
         "model": {**h["model"], "name": "ResNetSE34V2"},
         "dataloader_options": {**h["dataloader_options"], "batch_size": 3,
                                "num_workers": 2},
         "serving": {"batch_utts": 2, "max_wait_ms": 5}}
    for key in ("output_folder", "noise_folder", "verification_file",
                "pretrained", "cohorts_path"):
        h.pop(key, None)
    return h


def test_resnetse34v2_trains_evaluates_and_serves(tmp_path, capsys,
                                                  monkeypatch):
    torch.set_num_threads(2)
    files = _corpus(tmp_path)
    trials = tmp_path / "trials.txt"
    trials.write_text("".join(f"{int(a == b)} {files[a][0]} {files[b][1]}\n"
                              for a in files for b in files))
    h = _config(tmp_path, trials)
    cfg = tmp_path / "ecapa_tdnn.yaml"
    cfg.write_text(json.dumps(h))
    assert cli_main(["--do_train", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    assert "[DONE] min_loss" in capsys.readouterr().out
    run = tmp_path / "save" / "ResNetSE34V2" / "AAmSoftmax"
    for name in ("best_state.msgpack", "last_state.msgpack"):
        assert (run / "model" / name).exists(), name
    result = run / "result" / "evaluation_results.csv"
    scores = {}
    for tag, extra in (("fp32", []), ("int8", ["--quant", "int8"])):
        assert cli_main(["--do_infer", "--eval", "--config", str(cfg),
                         "--device", "cpu", *extra]) == 0
        text = capsys.readouterr().out
        assert "loaded weights" in text
        if tag == "int8":
            assert "int8: calibrated 2 activation scales" in text
        rows = result.read_text().strip().splitlines()
        assert len(rows) == 36 + 1
        scores[tag] = rows
    bf16 = tmp_path / "bf16.yaml"
    bf16.write_text(json.dumps({**h, "mixedprec": True}))
    assert cli_main(["--do_infer", "--eval", "--config", str(bf16),
                     "--device", "cpu"]) == 0
    assert len(result.read_text().strip().splitlines()) == 36 + 1
    embed = tmp_path / "embed.yaml"
    embed.write_text(json.dumps({**h, "prepare": "embed"}))
    assert cli_main(["--do_infer", "--prepare", "--config", str(embed),
                     "--device", "cpu"]) == 0
    assert np.load(run / "model" / "embeds.npy").shape[1] == 192
    capsys.readouterr()

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
        tt = np.arange(int(0.8 * SR)) / SR
        status, emb = _get(port, "POST", "/embed", {
            "pcm": (0.3 * np.sin(2 * np.pi * 150.0 * tt)).tolist(),
            "sample_rate": SR})
        assert status == 200 and emb["dim"] == 192
        assert abs(np.linalg.norm(emb["embedding"]) - 1) < 1e-4
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


def test_chip_smoke_zoo_hparams_mirror_the_yaml():
    """J's keys are ``yaml/ecapa_tdnn.yaml``'s but for the model (named,
    at its builder's nOut), the crops per utterance and the batch."""
    from test_torch_port_conformer_cli import _subset_of
    smoke = _chip_smoke()
    h = {k: v for k, v in smoke.RESNETSE_HPARAMS.items()
         if k not in ("model", "num_eval", "batch_size",
                      "dataloader_options", "save_model_last",
                      "ckpt_interval_minutes", "test_interval")}
    yaml = jconfig.read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    _subset_of(h, yaml, "ecapa_tdnn.yaml: ")
    opts = dict(smoke.RESNETSE_HPARAMS["dataloader_options"])
    assert opts.pop("batch_size") == 64
    _subset_of(opts, yaml["dataloader_options"], "dataloader_options: ")
    assert smoke.RESNETSE_HPARAMS["model"] == {
        "name": "ResNetSE34V2", "feature_type": "melspectrogram",
        "nOut": 256}


@pytest.mark.parametrize("model", ["ResNetSE34V2", "Raw_ECAPA_conv_asp"])
def test_chip_smoke_zoo_quant_table_is_what_the_model_quantizes(model):
    """One int8 forward of a 2 s crop at 16 kHz through the engine (the
    default floors): the K3 shapes it logs, per crop, are path J2's table
    (160 crops a batch)."""
    torch.set_num_threads(2)
    smoke = _chip_smoke()
    h = (smoke.RESNETSE_HPARAMS if model == "ResNetSE34V2"
         else smoke.RAW_ECAPA_HPARAMS)
    engine = InferenceEngine({**h, "quant": "int8"}, device="cpu")
    wave = (0.1 * np.random.default_rng(0).normal(0, 1, (1, 32000))).astype(
        np.float32)
    engine.embed_fn(wave)
    with smoke.quant_shape_log() as shapes:
        engine.embed_fn(wave)
    got = {}
    for (shape, n, _), calls in shapes.items():
        key = (tuple(shape[1:]), n)
        got[key] = got.get(key, 0) + calls
    want = {}
    for x_shape, n, per_fwd, _ in smoke.zoo_quant_table(model):
        assert x_shape[0] == 160
        want[(tuple(x_shape[1:]), n)] = per_fwd
    assert got == want
    assert len(engine.act_scales) == sum(want.values())


def test_chip_smoke_path_j_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py``'s path J driven on the CPU at a small size, so that
    its code runs before a chip call does: every model at its full width
    (TitaNet at size S, one mega block) on 0.5 s crops, 2 crops per
    utterance, 4 speakers × 2 crops per step, 300 classes, a corpus of 8
    speakers; one timed step, each other timing one call; K1's and K3's
    plain versions counted as their launches, host clocks for CUDA
    events, no profiles, no K3 trace; K3's table at a few of these
    shapes."""
    torch.set_num_threads(2)
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
    # the conv kernel's per-block trace and tile sweep need the card
    monkeypatch.setattr(smoke, "log_quant_trace", lambda *a: None)
    monkeypatch.setattr(smoke, "time_quant_tiles", lambda *a: None)
    batch = smoke.seeded_batch
    monkeypatch.setattr(smoke, "seeded_batch",
                        lambda seed, n_spk, n_per, h:
                        batch(seed, min(n_spk, 4), n_per, h))
    steps = smoke.time_steps
    monkeypatch.setattr(smoke, "time_steps",
                        lambda *a, **k: steps(*a, **{**k, "steps": 1,
                                                     "warmup": 0}))
    # each timing one call
    monkeypatch.setattr(smoke, "cuda_ms",
                        lambda fn, iters=20, warmup=3: (fn(), 1.0)[1])
    monkeypatch.setitem(smoke.ZOO_MODELS, "TitaNet", {
        **smoke.ZOO_MODELS["TitaNet"], "model_size": "s",
        "n_mega_blocks": 1})

    def shrink(h):
        return {**h, "num_eval": 2, "batch_size": 4, "nClasses": 300,
                "frontend_backend": "pallas",
                "audio_spec": {**h["audio_spec"], "sentence_len": 0.5},
                "dataloader_options": {**h["dataloader_options"],
                                       "batch_size": 4, "num_workers": 2}}

    monkeypatch.setattr(smoke, "RESNETSE_HPARAMS",
                        shrink(smoke.RESNETSE_HPARAMS))
    monkeypatch.setattr(smoke, "RAW_ECAPA_HPARAMS",
                        shrink(smoke.RAW_ECAPA_HPARAMS))
    # 16 served crops of 0.5 s: 51 frames, 7 after ResNetSE's strides; the
    # raw branch's columns over 296 and 98 steps
    monkeypatch.setattr(smoke, "ZOO_QUANT_SHAPES", [
        ((16, 2560, 7), 128, 1, "ResNetSE34V2 Conv_1 (attention)"),
        ((16, 5120), 256, 1, "ResNetSE34V2 Dense_0"),
        ((16, 768, 296), 256, 1, "Raw_ECAPA_conv_asp (a shape)"),
        ((16, 512), 512, 0, "Raw_ECAPA_conv_asp AFMS Dense_0")])
    real = smoke.zoo_quant_table

    def table(model):
        if model == "ResNetSE34V2":
            return real(model)
        # the small run's own shapes, each once: the rehearsal checks the
        # code, not the table (held above at the real crop)
        return [(s, n, c, "Raw_ECAPA_conv_asp") for s, n, c in
                RAW_SMALL_SHAPES]

    monkeypatch.setattr(smoke, "zoo_quant_table", table)
    out = smoke.path_j(tmp_path, "CPU", "cpu", torch.Generator())
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[J1]", "[J1 mfcc]", "[J1 spectrogram]",
                "[J2] int8 on the card vs", "[J2 ResNetSE34V2 new shapes",
                "[J3] Raw_tita", "[J3 Res_ECAPA]",
                "[J4 TitaNet gradient]", "[J4 ResNetSE34V2 bf16 mixedprec]",
                "[J5] --do_infer --eval"):
        assert tag in log, tag
    assert out["counts"]["quant_matmul"] == 2 + sum(
        c for _, _, c in RAW_SMALL_SHAPES)
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 1


# Raw_ECAPA_conv_asp's int8 forward of 16 crops of 0.5 s at 16 kHz (the
# ECAPA branch's 51 frames, the raw branch's 2,666 samples after its
# strided front): x, N, calls
RAW_SMALL_SHAPES = [
    ((16, 512, 51), 512, 6), ((16, 512, 1), 128, 3),
    ((16, 1536, 51), 1536, 1), ((16, 3072), 192, 1),
    ((16, 768, 296), 256, 1), ((16, 768, 98), 256, 4),
    ((16, 768, 32), 512, 1), ((16, 1536, 32), 512, 1),
    ((16, 1536, 10), 512, 4), ((16, 512), 512, 3), ((16, 512, 3), 128, 1),
    ((16, 1024), 320, 1)]
