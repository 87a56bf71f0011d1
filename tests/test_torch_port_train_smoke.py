"""``chip_smoke.py``'s path E (training) driven on the CPU at a tiny size,
so that its code runs before a chip call does: a small ECAPA_TDNN in
place of Raw3_ECAPA, 0.25 s crops, the mel kernel's route selected
(``frontend_backend: pallas``, which on CPU tensors is its plain
version, counted here as the kernel's launches), CUDA events and memory
counters replaced by host clocks and zeros. The card-vs-CPU checks then
compare the CPU with itself."""

import importlib.util
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class _HostEvent:
    def __init__(self, **kwargs):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_path_e_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    torch.set_num_threads(2)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    plain = tmf.mel_frontend_plain

    def counted(*args, **kwargs):
        tmf.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tmf, "mel_frontend_plain", counted)
    monkeypatch.setattr(smoke, "E_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(smoke, "profile", lambda *a, **k: None)
    writer = smoke.write_train_corpus
    monkeypatch.setattr(smoke, "write_train_corpus",
                        lambda root, sr: writer(root, sr, seconds=0.5))
    h = {**smoke.RAW3_TRAIN_HPARAMS,
         "audio_spec": {**smoke.RAW3_TRAIN_HPARAMS["audio_spec"],
                        "sentence_len": 0.25},
         "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                   "nOut": 16, "channels": [16, 16, 16, 16, 48],
                   "attention_channels": 4, "se_channels": 4,
                   "res2net_scale": 2},
         "features": "melspectrogram", "nClasses": 300, "num_eval": 2,
         "frontend_backend": "pallas"}
    out = smoke.path_e(tmp_path, "CPU", h)
    log = capsys.readouterr().out
    assert "[E1] card vs CPU over 3 steps" in log and " ok" in log
    assert "FAIL" not in log
    # one launch per forward: 1 gradient + 3 steps (E1); 13 fp32 and 13
    # bf16 steps, 8 steps of 2 microbatches, 2 halves and 1 step of 2
    # microbatches (E2; the profiles are left out here); 40 steps (E3);
    # 6 train steps and 6 eval batches (E4)
    assert out["counts"]["mel_frontend"] == 4 + (26 + 16 + 4) + 40 + 12
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 2
