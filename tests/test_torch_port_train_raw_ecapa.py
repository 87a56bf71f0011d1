"""The train step of ``yaml/voxceleb_raw_ecapa.yaml``'s stack at full
width, port against the JAX package (CPU): ``Raw_ECAPA_conv_asp`` (nOut
512: ECAPA-192 ∥ RawNet2Custom(conv, asp) 320) + ``AAmSoftmaxAP``
(margin 0.25, scale 30) over 17,982 classes + AdaBelief, 16 kHz, on 0.5 s
crops of 4 speakers × 2. One fp32 step and one bf16 step, each from the
same JAX state (a checkpoint the JAX package writes and the port
restores whole), each also run through the port in float64
(``Float64Port``): the exact reference both packages are measured from.

Unlike the default stack's RawNet3, whose log-sinc features make its
training-mode step ill-conditioned (``test_torch_port_train_raw3.py``),
this raw branch (a strided conv, no log) is well conditioned in fp32:
both packages sit within 5e-6 of float64 in the loss and the statistics
(measured, CHANGES.md), so the fp32 bars are tight. In bf16 both sit
0.15–0.3 % from float64 in the loss, with first-update cosines of
0.83 (JAX) and 0.86 (the port) to it (AdaBelief's first update is close to the sign of the
gradient, which bf16 rounding flips), so the bf16 bars are the default
stack's:

* fp32: loss within 1e-5 (relative) of float64's and of JAX's,
  statistics within 1e-4 (of each tensor's largest value), update
  cosine ≥ 0.999 to either;
* bf16: port's loss no farther from float64 than 1.5 × JAX's distance,
  its update's cosine to float64's within 0.05 of JAX's; port vs JAX
  loss 5e-2, update cosine ≥ 0.6.

Update cosines leave out the parameters whose gradient is zero by
construction (``ZERO_GRAD``): a softmax ignores a shift of all its
inputs, so the attention convs' biases (ECAPA's and the raw branch's
``Conv_2``), the BatchNorm bias before the raw branch's attention conv
and AngularProto's logit bias ``b`` move on rounding noise alone.
"""

import json
from pathlib import Path

import numpy as np
import torch

from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.data.audio import write_wav

from test_torch_port_train_helpers import raw3_steps

ROOT = Path(__file__).resolve().parents[1]

RAW_ECAPA = {"seed": 0,
             "audio_spec": {"sample_rate": 16000, "sentence_len": 0.5},
             "features": "raw", "n_mels": 80, "n_mfcc": 80,
             "model": {"name": "Raw_ECAPA_conv_asp", "feature_type": "raw",
                       "nOut": 512},
             "criterion": {"name": "AAmSoftmaxAP", "margin": 0.25,
                           "scale": 30},
             "nClasses": 17982, "lr": 0.003,
             "optimizer": {"name": "AdaBelief", "weight_decay": 2e-5,
                           "lr_decay": 0.95}}
ZERO_GRAD = ("AttentiveStatisticsPooling_0/Conv1d_0/Conv_0/bias",
             "raw_branch/Conv_2/bias", "raw_branch/BatchNorm_1/bias",
             "AngularProto_0/b")


def _steps(tmp_path, mixedprec):
    return raw3_steps(tmp_path, mixedprec=mixedprec, n_steps=1,
                      stack=RAW_ECAPA, zero_grad=ZERO_GRAD, samples=8000)


def test_raw_ecapa_conv_asp_fp32_step(tmp_path):
    torch.set_num_threads(2)
    row, = _steps(tmp_path, mixedprec=False)
    for other in ("ref", "jax"):
        assert abs(row["loss_port"] - row[f"loss_{other}"]) <= \
            1e-5 * abs(row["loss_ref"]), (other, row)
        assert row[f"stats_port_{other}"] <= 1e-4, (other, row)
        assert row[f"cos_port_{other}"] >= 0.999, (other, row)


def test_raw_ecapa_conv_asp_bf16_step(tmp_path):
    torch.set_num_threads(2)
    row, = _steps(tmp_path, mixedprec=True)
    ref = row["loss_ref"]
    assert abs(row["loss_port"] - ref) <= 1.5 * abs(row["loss_jax"] - ref)
    assert row["cos_port_ref"] >= row["cos_jax_ref"] - 0.05
    assert abs(row["loss_port"] - row["loss_jax"]) <= \
        5e-2 * abs(row["loss_jax"])
    assert row["cos_port_jax"] >= 0.6


def test_cli_trains_and_evaluates_the_yaml(tmp_path, capsys):
    """``--do_train`` for 2 epochs, then ``--do_infer --eval`` of its
    checkpoint, on ``yaml/voxceleb_raw_ecapa.yaml`` (the full-width
    model, head, optimizer and schedule) with its paths in a tmpdir,
    0.25 s crops and 3 speakers × 2 crops per step over 6 synthetic
    speakers (3 of each one's 6 files train, 3 validate)."""
    torch.set_num_threads(2)
    sr = 16000
    rng = np.random.default_rng(0)
    files = {}
    for spk in range(6):
        for utt in range(6):
            tt = np.arange(int(0.6 * sr)) / sr
            sig = (0.3 * np.sin(2 * np.pi * (120 + 70 * spk) * tt
                                + rng.uniform(0, 6))
                   + rng.normal(0, 0.01, tt.size))
            path = tmp_path / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), sr)
            files.setdefault(spk, []).append(str(path))
    trials = tmp_path / "trials.txt"
    trials.write_text("".join(f"{int(a == b)} {files[a][0]} {files[b][1]}\n"
                              for a in files for b in files))
    h = read_config(ROOT / "yaml" / "voxceleb_raw_ecapa.yaml")
    h.update({"save_folder": str(tmp_path / "save"),
              "data_folder": str(tmp_path / "data"),
              "train_annotation": str(tmp_path / "meta" / "train.csv"),
              "valid_annotation": str(tmp_path / "meta" / "dev.csv"),
              "evaluation_file": str(trials), "number_of_epochs": 2,
              "batch_size": 3, "num_eval": 2, "test_interval": 1,
              "audio_spec": {**h["audio_spec"], "sentence_len": 0.25},
              "dataloader_options": {**h["dataloader_options"],
                                     "batch_size": 3, "num_workers": 2}})
    cfg = tmp_path / "voxceleb_raw_ecapa.yaml"
    cfg.write_text(json.dumps(h))            # YAML's JSON subset
    assert cli_main(["--do_train", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    assert "[DONE] min_loss" in capsys.readouterr().out
    run = tmp_path / "save" / "Raw_ECAPA_conv_asp" / "AAmSoftmaxAP"
    scores = (run / "result" / "scores.txt").read_text().splitlines()
    assert [s.split(",")[0] for s in scores] == ["epoch 1", "epoch 2"]
    assert cli_main(["--do_infer", "--eval", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    assert "loaded weights" in capsys.readouterr().out
    rows = (run / "result" / "evaluation_results.csv").read_text()
    assert len(rows.strip().splitlines()) == 36 + 1
