"""``chip_smoke.py``'s path O (the multi-GPU code on one card) driven on
the CPU at a tiny size, so that its code, its rank programs and its
two-process CLI runs work before a chip call does: a small ECAPA_TDNN in
place of Raw3_ECAPA, gloo in place of NCCL at world size 1, a bank of
3,000 rows. The one-process references are the CPU's own."""

import importlib.util
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

SMALL = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram", "nOut": 16,
         "channels": [16, 16, 16, 16, 48], "attention_channels": 4,
         "se_channels": 4, "res2net_scale": 2}


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_path_o_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    torch.set_num_threads(2)
    smoke = _load_smoke()
    base = smoke.RAW3_TRAIN_HPARAMS
    h = {**base, "audio_spec": {**base["audio_spec"], "sentence_len": 0.25},
         "model": dict(SMALL), "features": "melspectrogram", "nClasses": 12,
         "num_eval": 2, "batch_size": 4,
         "dataloader_options": {**base["dataloader_options"],
                                "batch_size": 4, "num_workers": 1}}
    embed_h = {**smoke.RAW3_ECAPA_HPARAMS,
               "audio_spec": {**smoke.RAW3_ECAPA_HPARAMS["audio_spec"],
                              "sentence_len": 0.25},
               "model": {**SMALL, "conv_backend": "pallas"},
               "features": "melspectrogram"}
    # the mel kernel's route on CPU tensors is its plain version: counted
    # here as the kernel's launches
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    plain = tmf.mel_frontend_plain

    def counted(*args, **kwargs):
        tmf.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tmf, "mel_frontend_plain", counted)
    h["frontend_backend"] = "pallas"
    monkeypatch.setattr(smoke, "O_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "O_H", h)
    monkeypatch.setattr(smoke, "O_EMBED_H", embed_h)
    monkeypatch.setattr(smoke, "O_SIZES", {
        "speakers": 4, "tp_speakers": 2, "tp_classes": 8, "bank_rows": 3000,
        "bank_dim": 16, "bank_queries": 5, "embed_crops": 6,
        "cli_speakers": 4, "o1_steps": 2})
    writer = smoke.write_train_corpus
    monkeypatch.setattr(smoke, "write_train_corpus",
                        lambda root, sr, **kw: writer(
                            root, sr, **{**kw, "seconds": 0.5}))
    out = smoke.path_o(tmp_path, "CPU")
    log = capsys.readouterr().out
    print(log)
    assert "FAIL" not in log
    for tag in ("[O1] the DP step over gloo at world size 1",
                "[O2] two ranks", "[O3] data 1 x model 2", "[O4 bank]",
                "[O4 eval]", "[O5]", "[O6]"):
        assert tag in log, tag
    assert out["o1"]["bit_equal"]
    assert "2 steps of 8 crops" in log
    assert out["o6"]["diff"] <= 1e-5
