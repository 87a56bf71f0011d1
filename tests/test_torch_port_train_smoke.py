"""``chip_smoke.py``'s path E (training) driven on the CPU at a tiny size,
so that its code runs before a chip call does: a small ECAPA_TDNN in
place of Raw3_ECAPA, 0.25 s crops, the mel kernel's route selected
(``frontend_backend: pallas``, which on CPU tensors is its plain
version, counted here as the kernel's launches), CUDA events and memory
counters replaced by host clocks and zeros. The card-vs-CPU checks then
compare the CPU with itself."""

import functools
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


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _patch_for_cpu(smoke, tmf, monkeypatch, n_spk: int = 64):
    """The paths on the CPU: the mel kernel's plain version counted as
    its launches, host clocks for CUDA events, no profiles, a corpus of
    ``n_spk`` speakers' 0.5 s WAVs."""
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
    monkeypatch.setattr(smoke, "profile", lambda *a, **k: 0.0)
    writer = smoke.write_train_corpus
    monkeypatch.setattr(smoke, "write_train_corpus",
                        lambda root, sr, **kw: writer(
                            root, sr, **{**kw, "n_spk": n_spk,
                                         "seconds": 0.5}))


def test_chip_smoke_path_e_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    torch.set_num_threads(2)
    smoke = _load_smoke()
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    _patch_for_cpu(smoke, tmf, monkeypatch)
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
    # one launch per forward: 1 gradient + 3 steps (E1); 8 fp32 and 8
    # bf16 steps, 7 steps of 2 microbatches, 2 halves and 1 step of 2
    # microbatches (E2; the profiles are left out here); 40 steps (E3);
    # 6 train steps and 6 eval batches (E4)
    assert out["counts"]["mel_frontend"] == 4 + (16 + 14 + 4) + 40 + 12
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 2


def _narrow_rawnet2_family(monkeypatch):
    """The family's builders at small widths (they pin the full ones,
    which tests/test_torch_port_rawnet2_builders.py holds against JAX): a
    16-channel ECAPA branch, RawNet2Custom filters (8, 8, 16, 16, 32, 32)
    with a 16-unit GRU, RawNet2 at 8 and 16 filters."""
    from speakerverification_tpu_torch.models import (
        hybrids,
        rawnet2,
        rawnet2_custom,
    )
    from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN

    def ecapa(n_mels, input_norm, remat=False):
        return ECAPA_TDNN(n_mels=n_mels, lin_neurons=192,
                          channels=(16, 16, 16, 16, 48),
                          attention_channels=4, se_channels=4,
                          res2net_scale=2, feature_type="melspectrogram",
                          log_input=False, input_norm=input_norm,
                          remat=remat)

    custom = functools.partial(rawnet2_custom.RawNet2Custom,
                               filters=(8, 8, 16, 16, 32, 32), gru_node=16)
    monkeypatch.setattr(hybrids, "_hybrid_ecapa", ecapa)
    monkeypatch.setattr(hybrids, "RawNet2Custom", custom)
    monkeypatch.setattr(rawnet2_custom, "RawNet2Custom", custom)
    monkeypatch.setattr(rawnet2, "RawNet2", functools.partial(
        rawnet2.RawNet2, first_filters=8, gru_node=16,
        block_filters=((8, 8), (8, 8), (8, 16), (16, 16), (16, 16),
                       (16, 16))))


def test_chip_smoke_path_f_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Path F (the RawNet2 family) with every builder at small widths, on
    0.35 s crops (the sinc front and seven pools of 3 need 2,437
    samples), 2 crops per utterance, 4 speakers × 2 crops per train step
    and a corpus of 8 speakers."""
    torch.set_num_threads(4)
    smoke = _load_smoke()
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    _patch_for_cpu(smoke, tmf, monkeypatch, n_spk=8)
    _narrow_rawnet2_family(monkeypatch)
    batch = smoke.seeded_batch
    monkeypatch.setattr(smoke, "seeded_batch",
                        lambda seed, n_spk, n_per, h:
                        batch(seed, min(n_spk, 4), n_per, h))

    def shrink(h):
        return {**h, "num_eval": 2, "batch_size": 4,
                "frontend_backend": "pallas",
                "audio_spec": {**h["audio_spec"], "sentence_len": 0.35},
                "dataloader_options": {**h.get("dataloader_options", {}),
                                       "batch_size": 4}}

    monkeypatch.setattr(smoke, "F3_VARIANTS",
                        [(y, shrink(h)) for y, h in smoke.F3_VARIANTS])
    out = smoke.path_f(tmp_path, "CPU", shrink(smoke.RAW_ECAPA_HPARAMS))
    log = capsys.readouterr().out
    assert "[F2 gradient]" in log and "FAIL" not in log
    for name in ("Raw_ECAPA", "Raw_ECAPA_sinc_gru", "RawNet2_custom",
                 "Raw_ECAPA_sinc_asp", "Raw_ECAPA_hype", "RawNet2"):
        assert f"[F3 {name}]" in log
    assert out["counts"]["mel_frontend"] > 0
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 2


def test_chip_smoke_path_g_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Path G (training with augmentation) with small ECAPA_TDNNs in place
    of Raw3_ECAPA and the 1024-channel ECAPA_TDNN, 0.25 s crops, 4
    speakers x 2 crops per step, a corpus of 8 speakers and 1 s noise
    files."""
    torch.set_num_threads(2)
    smoke = _load_smoke()
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    _patch_for_cpu(smoke, tmf, monkeypatch, n_spk=8)
    noise = smoke.write_noise_corpus
    monkeypatch.setattr(smoke, "write_noise_corpus",
                        lambda root, sr: noise(root, sr, n_files=3,
                                               seconds=1.0, rir_seconds=0.1))
    small = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
             "nOut": 16, "channels": [16, 16, 16, 16, 48],
             "attention_channels": 4, "se_channels": 4, "res2net_scale": 2}

    def shrink(h):
        return {**h, "model": small, "features": "melspectrogram",
                "nClasses": 300, "num_eval": 2, "frontend_backend": "pallas",
                "audio_spec": {**h["audio_spec"], "sentence_len": 0.25},
                "dataloader_options": {**h["dataloader_options"],
                                       "batch_size": 4, "num_workers": 2}}

    monkeypatch.setattr(smoke, "RAW3_TRAIN_HPARAMS",
                        shrink(smoke.RAW3_TRAIN_HPARAMS))
    monkeypatch.setattr(smoke, "ECAPA_TRAIN_HPARAMS",
                        shrink(smoke.ECAPA_TRAIN_HPARAMS))
    out = smoke.path_g(tmp_path, "CPU")
    log = capsys.readouterr().out
    for tag in ("[G1 loader augment off]", "[G1 loader host augment]",
                "[G1 loop host augment]", "[G2 device np]",
                "[G2 device torch]", "[G2] step", "[G3] ECAPA_TDNN",
                "[G4] --do_train"):
        assert tag in log, tag
    assert "FAIL" not in log and "env_corrupt moved on-device" in log
    assert out["counts"]["mel_frontend"] > 0
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 2


def test_chip_smoke_path_h_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Path H (the data path) with small ECAPA_TDNNs in place of Raw3_ECAPA
    and the 1024-channel ECAPA_TDNN, 0.25 s crops, 4 speakers x 2 crops
    per step, G's corpora at 8 speakers and 1 s noise files: the native
    reader, ``cli.dataprep``'s verbs, the readers' costs, the loaders
    feeding the step, ``--do_train`` from shards and ``remat``."""
    torch.set_num_threads(2)
    smoke = _load_smoke()
    from speakerverification_tpu_torch.ops import mel_frontend as tmf
    _patch_for_cpu(smoke, tmf, monkeypatch, n_spk=8)
    noise = smoke.write_noise_corpus
    monkeypatch.setattr(smoke, "write_noise_corpus",
                        lambda root, sr: noise(root, sr, n_files=3,
                                               seconds=1.0, rir_seconds=0.1))
    small = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
             "nOut": 16, "channels": [16, 16, 16, 16, 48],
             "attention_channels": 4, "se_channels": 4, "res2net_scale": 2}

    def shrink(h):
        return {**h, "model": small, "features": "melspectrogram",
                "nClasses": 300, "num_eval": 2, "frontend_backend": "pallas",
                "audio_spec": {**h["audio_spec"], "sentence_len": 0.25},
                "dataloader_options": {**h["dataloader_options"],
                                       "batch_size": 4, "num_workers": 2}}

    monkeypatch.setattr(smoke, "RAW3_TRAIN_HPARAMS",
                        shrink(smoke.RAW3_TRAIN_HPARAMS))
    monkeypatch.setattr(smoke, "ECAPA_TRAIN_HPARAMS",
                        shrink(smoke.ECAPA_TRAIN_HPARAMS))
    out = smoke.path_h(tmp_path, "CPU")
    log = capsys.readouterr().out
    for tag in ("[H0 reader]", "[H1 prepare]", "[H1 noise verbs]",
                "[H2 read cost]", "[H2 loader threads] shards host augment",
                "[H2 batches] host augment",
                "[H3 loop in memory]", "[H3 loop native WAV]",
                "[H3 loop shards]", "[H3 loop shards + device_augment np]",
                "[H3] step alone",
                "[H4] --do_train read", "[H5] remat"):
        assert tag in log, tag
    assert "FAIL" not in log
    assert out["counts"]["mel_frontend"] > 0
    assert out["counts"]["res2net_cascade"] == 0
    assert len(out["epochs_s"]) == 2
    assert min(out["h5"]["cosines"].values()) >= 0.99999
