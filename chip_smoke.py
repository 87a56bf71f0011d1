#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``speakerverification_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --f2-conv  # only F2's step under each remedy of
                                     # its FFT convolution gradient
    python3 chip_smoke.py --forwards # only paths A, B and F1's forwards,
                                     # timed (to compare two trees)
    python3 chip_smoke.py --data-path  # only path H (the data path)
    python3 chip_smoke.py --conformer  # only path I (the Conformer family)
    python3 chip_smoke.py --zoo        # only path J (ResNetSE, TitaNet,
                                       # hybrids2, int8 of RawNet2)
    python3 chip_smoke.py --train-zoo  # only path L (the loss and
                                       # optimizer zoos)
    python3 chip_smoke.py --model-zoo  # only path M (the rest of the
                                       # model zoo)
    python3 chip_smoke.py --export-tools  # only path N (export, the
                                          # feature-domain ops, the tools)
    python3 chip_smoke.py --multi-gpu  # only path O (the multi-GPU code
                                       # on one card)
    python3 chip_smoke.py --checkpoints  # only path P (reference torch
                                         # checkpoints, JAX orbax dirs)

Phases, each of which fails the run:
  1. build the hand-written kernels from ``speakerverification_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, and time kernel, plain version and library call;
  3. path A: the default Raw3_ECAPA model at full width behind the HTTP
     serving app (``/healthz``, ``/embed``, ``/score``), mel kernel counted;
  4. path B: ECAPA_TDNN at 1024 channels with ``conv_backend: pallas``,
     one serving batch, mel and cascade kernels counted;
  5. path C: offline trial evaluation (``inference(h, eval_=True)``, the
     ``--do_infer --eval`` verb) of Raw3_ECAPA at full width with
     ``quant: int8`` on synthetic WAVs, mel and int8 GEMM kernels counted,
     scores held against the float path on the same trials; then the
     eval wall of a list of VoxCeleb1-O's size (4,880 files, 37,720 trials);
  6. throughput and a profile of paths A-C;
  7. path D: full-width Raw3_ECAPA from msgpack checkpoints in the JAX
     package's layout, written here by the port (best/last/top-k/EMA:
     selection, soup, EMA), through ``inference()``'s verbs (prepare embed
     and cohorts, eval and test with S-norm, predict), the HTTP bank routes
     (``/identify``, ``/enroll``, ``/unenroll``) with the bank on the card,
     and a bank of 1,000,000 rows x 512 in fp32 and bf16;
  8. path E: training the default stack at full width (Raw3_ECAPA +
     ARmSoftmax over 13,103 classes + AdaBelief): E1 three train steps on
     the card against the CPU's, each from the same state; E2 the step at
     the full batch (64 crops of 2 s) in fp32, bf16 and with
     accumulate_steps 2, timed and profiled; E3 learning on one fixed
     batch; E4 ``--do_train`` through the CLI on a synthetic manifest,
     then ``--do_infer --eval`` of the trained checkpoint;
  9. path F: the RawNet2 family at full width, 16 kHz, 2 s crops
     (``yaml/voxceleb_raw_ecapa.yaml``): F1 Raw_ECAPA_conv_asp behind the
     HTTP app, timed and profiled at the serving batch (8 x 20 crops);
     F2 its train step with AAmSoftmaxAP over 17,982 classes and
     AdaBelief: the gradient against the CPU's by branch, the 64-crop
     step timed and profiled in fp32 and bf16, learning on one batch; F3
     every other builder of the family (Raw_ECAPA, Raw_ECAPA_sinc_gru,
     RawNet2_custom, Raw_ECAPA_sinc_asp, Raw_ECAPA_hype, RawNet2) against
     the CPU; F4 ``--do_train`` then ``--do_infer --eval`` through the CLI;
 10. path G: training with augmentation on synthetic noise corpora in
     MUSAN / RIRS_NOISES' layout: G1 ``raw3_ecapa.yaml``'s keys with
     ``augment: true`` (host env_corrupt and time_domain on the loader's
     threads): the loader's ms per batch with and without, each over a
     full epoch on 1 and on 8 threads, the step, and the loader feeding
     the step; G2 ``device_augment`` with
     ``device_time_augment`` ``np`` and ``torch`` inside the Trainer's
     step, each apply on the card against the CPU with the same drawn
     numbers, the env types' shares over 65,536 rows drawn on the card;
     G3 ``ecapa_tdnn.yaml``'s keys, its step fed batches that its loader
     corrupted (env_corrupt), SpecAugment after K1 (card against CPU, a
     timed step, learning on one batch); G4
     ``--do_train --augment`` then ``--do_infer --eval`` through the CLI;
 11. path H: the data path on path G's corpora: H0 the native WAV reader
     built with g++ and held bit for bit to the NumPy parser on every
     format; H1 ``cli.dataprep --generate --pack`` (8 kHz) and ``--pack``
     (16 kHz), and ``--stats``, ``--vad``, ``--restore``,
     ``--split_musan`` on the noise corpus, each count checked; H2 the
     readers' CPU ms per crop (native, NumPy, a shard crop; the file
     read, the decode and the crop on their own) and the loader over an epoch on 1 and 8 threads from
     WAVs and from shards, with and without host augmentation, shard
     batches equal to WAV batches; H3 the G1 step alone and fed by each
     loader (and by shards with ``device_augment``); H4 ``--do_train``
     from ``dataloader_options.shards``, then ``--do_infer --eval``; H5
     ECAPA_TDNN-1024's step with and without ``model.remat``: ms, peak
     memory, gradients;
 12. path I: the Conformer family (``yaml/model_plot.yaml``): I1
     Conformer behind the HTTP app at 8 x 20 crops of 2 s, timed, its
     peak memory, profiled; I2 the same model with ``quant: int8``
     (14 launches of K3's Dense route per forward) against the plain
     int8 path on the CPU and the float path; I3 K3's Dense route at
     every Conformer and ECAPA_Conformer shape, fp32 and bf16, bit for
     bit and timed; I4 the Conformer train step (AAmSoftmaxAP over 5,994,
     AdaBelief): the gradient by module and three steps against the CPU
     with dropout off, then the 64 x 2-crop step with dropout timed in
     fp32 and bf16, learning on one batch; I5 ECAPA_Conformer served
     (against the CPU) and one step, with peak memories; I6
     ``--do_train`` then ``--do_infer --eval`` through the CLI;
 13. path J: the ResNetSE and TitaNet families and ``hybrids2``
     (``yaml/ecapa_tdnn.yaml``'s keys): J1 ResNetSE34V2 behind the HTTP
     app at 8 x 20 crops of 2 s, timed, its peak memory, profiled, then
     on ``mfcc`` and ``spectrogram`` features (no K1) against the CPU;
     J2 ResNetSE34V2 and Raw_ECAPA_conv_asp with ``quant: int8`` (2 and
     27 K3 launches per forward, at the table's shapes) against the
     plain int8 path on the CPU and the float path, and K3 at every new
     shape in fp32 and bf16, bit for bit and timed; J3 TitaNet-L,
     Tita_ECAPA, Raw_tita and Res_ECAPA at their builders' defaults, one
     served batch each against the CPU, timed; J4 the 64 x 2-crop
     AAmSoftmax step of ResNetSE34V2 and TitaNet-L: the gradient by
     module against the CPU with dropout off, the step timed with
     dropout in fp32 and bf16; J5 ``--do_train`` then ``--do_infer
     --eval`` through the CLI;
 14. path L: the loss and optimizer zoos on the default stack at path E's
     width (Raw3_ECAPA, 8 kHz, 32 x 2 crops of 2 s, 13,103 classes): L1
     the 17 new heads on the embeddings of one training forward, card
     against CPU (loss, prec1, gradients), the embedding norms logged;
     L2 each head in the train step, 10 steps on one batch (6 in the
     whole script), the loss
     falling (a head that diverges or overflows as in JAX held to the
     CPU's first step instead), the step timed, K1 counted; L3 the 24 new
     optimizers and Lookahead over AdaBelief: three updates with
     full-width gradient trees on the card against the CPU (Shampoo one,
     its CPU side over the leaves with axes <= 4,096), then five train
     steps (three in the whole script), ``tx.update``
     timed as its share of the step; L4 Adahessian's true second-order
     step (double backward) against its plain one, time and peak
     memory; L5 ``--do_train`` with MSAmSoftmax and Lamb, its optimizer
     state read back, then ``--do_infer --eval`` (the whole script runs
     Shampoo on the head's first 2,048 classes, ``--train-zoo`` on all);
 15. path M: the rest of the model zoo (``yaml/ecapa_tdnn.yaml``'s audio
     keys, 8 x 20 crops of 2 s a served batch): M1 EfficientNet-b4,
     EfficientNetv2-s, RepVGG-D2se, SCNet-50 and DPN at their builders'
     defaults, one served batch each against the CPU (K1 once per
     forward), timed, peak memory, RepVGG's deploy fold against its train
     layout; M2 RawNeXt, ResNeXt and RawNet3 alike, RawNet3's other
     options on 32 crops against the CPU; M3 ``[RawNet3, ECAPA_TDNN]``
     (``raw3_ecapa.yaml``'s keys, ``conv_backend: pallas``) served (K1
     once, K2 three times per forward), K2 at its shape; M4 ``quant:
     int8`` of each against the plain int8 path on the CPU and the float
     path, K3 at every new shape, bit for bit and timed; M5 the 64 x
     2-crop AAmSoftmax step of EfficientNet-b4 and RawNeXt: the gradient
     by module against the CPU, the fp32 step timed; M6 TDFbanks and the
     pooling modules against the CPU;
 16. path N: export and the tools: N1 ``--do_export`` through the CLI of
     ``raw3_ecapa.yaml``'s keys with ``conv_backend: pallas`` (seeded
     weights, random BN) at [20, 16,000], the program loaded in a fresh
     process against the live engine (cosine, rtol 1e-4, atol 1e-5),
     K1 and K2 counted among the kernels of its trace of one profiled
     forward, and here, program and live engine timed in turns (and
     profiled when path N runs alone), the forward's FLOPs
     (``utils.summary.forward_flops``) as TFLOP/s, then
     ``raw3_ecapa.yaml`` itself exported; N2 the same in bf16
     (``--mixedprec``); N3 int8 and ONNX export refused; N4 every
     function of ``ops/signal.py``, ``ops/features_extra.py`` and
     ``ops/filteraugment.py``'s cores on the card against the CPU at
     [64, 16,000] waves, 4,000-tap RIRs and [64, 201, 80] features,
     timed, and the random ops drawing from the card's generator; N5
     ``--list_components``, ``--sys_info`` and a 2-step first epoch of the
     default stack with ``profile: true``, its ``trace.json`` holding the
     K1 kernel;
 17. path O: the multi-GPU code on one card (NCCL refuses two ranks on
     one GPU: the NCCL path runs at world size 1, the multi-rank math as
     two processes on cuda:0 over gloo): O1 the default stack's
     data-parallel step over NCCL at world size 1 against the plain step,
     three steps each, bit for bit or within 1e-6, ms per step, K1 in a
     profiled step; O2 two ranks of 16 x 2 crops against one process's
     ``accumulate_steps: 2`` step on the 32 x 2 batch (loss 1e-4, each
     gradient's cosine >= 0.9999, the BN statistics meaned); O3 data 1 x
     model 2 with AAmSoftmax over 5,994 classes against the unsharded
     step (loss and prec1 1e-5, cosines >= 0.9999), each rank's bytes of
     the head; O4 a ``ShardedSpeakerBank`` of two shards on the card at
     1,000,000 x 512 against ``SpeakerBank`` (top-5 indices equal,
     scores 1e-6), ms per identify, and ``make_eval_embed_fn`` split over
     the card named twice with K1 and K2 against one device (cosine >=
     0.9999999); O5 O3's state through ``save_sharded``,
     ``async_save_sharded`` + ``wait`` and its msgpack, read into one
     process bit for bit, seconds and bytes; O6 ``--do_train
     --distributed --distributed_backend gloo --model_parallel 2`` run
     by O2's two ranks through the CLI's ``main``, one epoch of 2 steps
     with sharded checkpoints, then ``--do_infer --eval`` split over them
     against one process's (scores 1e-5);
 18. path P: checkpoints from elsewhere. P1 a reference training
     checkpoint of the full-width Raw3_ECAPA (``module.__S__.`` keys of
     ``tests/data/raw3_ecapa.torch_shapes.json``, seeded values, the
     ARmSoftmax head's ``__L__.weight``) through the converter CLI
     (``python -m speakerverification_tpu_torch.compat.torch_port``), then
     ``--do_infer --eval`` of it in fp32 with ``conv_backend: pallas`` (K1
     and K2 counted) and in int8 (K3, 22 a batch), the served weights
     equal to ``state_dict_from_reference``'s, the card at cosine >=
     0.9999 to the CPU plain path, ms a batch; P2 the reverse CLI
     (``compat.torch_export --shapes``) giving back the reference's
     backbone and head bit for bit; P3 the JAX package's orbax fixture
     ``tests/data/orbax_ecapa`` served as ``initial_model_infer`` (K1 and
     K2 counted), at cosine >= 0.9999 to JAX's stored embeddings, and the
     zstd decoder's MB/s on its frames.
Every path is compared with the same model's plain path on the CPU.
The whole script times its train steps without profiling them and at
most 2 of them after one warm-up, reads each loader over its first 8
batches, runs L2 and L3 over fewer steps and L3 over 2 updates, and
times path C's eval on a quarter of VoxCeleb1-O's list (``PROFILE_STEPS``,
``TIMED_STEPS_CAP``, ``LOADER_BATCHES``, ``L2_STEPS``, ``L3_STEPS``,
``L3_UPDATES``, ``C_LIST_SHARE``); a path run alone profiles its steps,
reads whole epochs and takes the full depth.

The script imports nothing of the JAX package. hparams are built in code
(they mirror ``yaml/raw3_ecapa.yaml``, ``yaml/ecapa_tdnn.yaml``,
``yaml/voxceleb_raw_ecapa.yaml``, the yamls of path F3 and
``yaml/model_plot.yaml``, which CPU tests check; paths J and M take
``ecapa_tdnn.yaml``'s, M3 ``raw3_ecapa.yaml``'s). The last line of
standard output is the JSON result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.time()

# H100 SXM published peaks (dense): fp32 outside the tensor cores, TF32
# and bf16 tensor cores, int8, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# the serving-relevant keys of yaml/raw3_ecapa.yaml (path A) and
# yaml/ecapa_tdnn.yaml (path B); tests/test_torch_port_serving.py holds
# them against the files
RAW3_ECAPA_HPARAMS = {
    "seed": 20220709,
    "audio_spec": {"sample_rate": 8000, "channels": 1, "sentence_len": 2.0,
                   "win_len": 0.025, "hop_len": 0.01},
    "n_mfcc": 80, "n_mels": 80, "features": "raw",
    "model": {"name": "Raw3_ECAPA", "feature_type": "raw", "nOut": 512},
    "num_eval": 20,
}
ECAPA_TDNN_HPARAMS = {
    "seed": 20220709,
    "audio_spec": {"sample_rate": 16000, "channels": 1, "sentence_len": 2.0,
                   "win_len": 0.025, "hop_len": 0.01},
    "n_mfcc": 80, "n_mels": 80, "features": "melspectrogram",
    "fmin": 20.0, "fmax": 7600.0,
    "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
              "nOut": 192},
    "num_eval": 10,
}
# the training keys of yaml/raw3_ecapa.yaml (path E; the same test holds
# them against the file)
RAW3_TRAIN_HPARAMS = {
    **RAW3_ECAPA_HPARAMS,
    "number_of_epochs": 250, "batch_size": 32, "lr": 0.003,
    "base_lr": 1e-8, "max_lr": 0.003, "step_size": 10, "shuffle": False,
    "random_chunk": True, "nClasses": 13103,
    "dataloader_options": {"batch_size": 32, "shuffle": False,
                           "num_workers": 8, "max_seg_per_spk": 1000,
                           "nPerSpeaker": 2, "split_ratio": -1},
    "criterion": {"name": "ARmSoftmax", "margin": 0.2, "scale": 30},
    "optimizer": {"name": "AdaBelief", "weight_decay": 0.00002,
                  "lr_decay": 0.95},
    "callbacks": {"name": "cosine_annealinglr_pt", "base_lr": 1e-8,
                  "max_lr": 0.003},
    "early_stopping": False, "es_patience": 15, "augment": False,
    "save_model_last": True, "ckpt_interval_minutes": -1,
    "test_interval": -1,
}
# the keys of yaml/voxceleb_raw_ecapa.yaml (path F: the RawNet2 family's
# hybrid Raw_ECAPA_conv_asp and the AAmSoftmaxAP head; the same test
# holds them against the file)
RAW_ECAPA_HPARAMS = {
    "seed": 20220829,
    "audio_spec": {"sample_rate": 16000, "channels": 1, "sentence_len": 2.0,
                   "win_len": 0.025, "hop_len": 0.01},
    "n_mfcc": 80, "n_mels": 80, "features": "raw",
    "model": {"name": "Raw_ECAPA_conv_asp", "feature_type": "raw",
              "nOut": 512},
    "num_eval": 20,
    "number_of_epochs": 500, "batch_size": 32, "lr": 0.003,
    "base_lr": 1e-8, "max_lr": 0.003, "step_size": 10, "shuffle": False,
    "random_chunk": True, "nClasses": 17982,
    "dataloader_options": {"batch_size": 32, "shuffle": False,
                           "num_workers": 8, "max_seg_per_spk": 1000,
                           "nPerSpeaker": 2, "split_ratio": -1},
    "criterion": {"name": "AAmSoftmaxAP", "margin": 0.25, "scale": 30},
    "optimizer": {"name": "AdaBelief", "weight_decay": 0.00002,
                  "lr_decay": 0.95},
    "callbacks": {"name": "cosine_annealinglr_pt", "base_lr": 1e-8,
                  "max_lr": 0.003},
    "early_stopping": False, "es_patience": 15, "augment": False,
    "save_model_last": True, "ckpt_interval_minutes": -1,
    "test_interval": -1,
}


def _variant(seed: int, model: str, sr: int, seconds: float,
             criterion: dict) -> dict:
    return {"seed": seed,
            "audio_spec": {"sample_rate": sr, "channels": 1,
                           "sentence_len": seconds, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mfcc": 80, "n_mels": 80, "features": "raw",
            "model": {"name": model, "feature_type": "raw", "nOut": 512},
            "num_eval": 20, "criterion": criterion}


AAMAP = {"name": "AAmSoftmaxAP", "margin": 0.2, "scale": 30}
# path F3: the family's other builders, each with the keys of the yaml that
# names it (the same test holds them against the file); a builder no yaml
# names takes voxceleb_raw_ecapa.yaml's
F3_VARIANTS = [
    ("verification.yaml", _variant(8888, "Raw_ECAPA", 8000, 1.0,
                                   {"name": "ARmSoftmax", "margin": 0.2,
                                    "scale": 30})),
    ("dataprep.yaml", _variant(20220928, "Raw_ECAPA_sinc_gru", 16000, 2.0,
                               AAMAP)),
    ("vlsp_rawnet2.yaml", _variant(20220808, "RawNet2_custom", 16000, 2.0,
                                   AAMAP)),
    ("voxceleb_raw_ecapa.yaml", {**RAW_ECAPA_HPARAMS, "model": {
        **RAW_ECAPA_HPARAMS["model"], "name": "Raw_ECAPA_sinc_asp"}}),
    ("voxceleb_raw_ecapa.yaml", {**RAW_ECAPA_HPARAMS, "model": {
        **RAW_ECAPA_HPARAMS["model"], "name": "Raw_ECAPA_hype"}}),
    ("voxceleb_raw_ecapa.yaml", {**RAW_ECAPA_HPARAMS, "model": {
        **RAW_ECAPA_HPARAMS["model"], "name": "RawNet2"}}),
]
BATCH_UTTS = 8          # the serving default (serving.batch_utts)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ----------------------------------------------------------------------
# phase 1-2: kernels
# ----------------------------------------------------------------------
KERNELS = ("mel_frontend", "res2net_cascade", "quant_matmul")


def build_kernels():
    from speakerverification_tpu_torch.ops import _build
    t0 = time.time()
    _build.build(*KERNELS)
    log(f"[build] {len(KERNELS)} kernels built in {time.time() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for name in KERNELS:
        text = (_build.BUILD_DIR / f"{name}.log").read_text()
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                log(f"[ptxas {name}] {line.strip()}")


def check_mel_kernel(dev, gen):
    """K1 against its plain version at both configs' serving shapes."""
    import torch
    from speakerverification_tpu_torch.ops import mel_frontend as mf
    from speakerverification_tpu_torch.ops.frontend import (
        FrontendConfig,
        mel_constants,
        pre_emphasis,
        reflect_pad,
        window_rows,
    )
    results = []
    # (label, config, rows = batch_utts * num_eval, samples)
    shapes = [("raw3_ecapa 8k", FrontendConfig(), 8 * 20, 16000),
              ("ecapa_tdnn 16k", FrontendConfig(sample_rate=16000,
                                                win_length=400,
                                                hop_length=160,
                                                fmin=20.0, fmax=7600.0),
               8 * 10, 32000),
              # path E's train step: 32 speakers x 2 crops of 2 s
              ("raw3_ecapa 8k train", FrontendConfig(), 32 * 2, 16000),
              # path F: Raw_ECAPA_conv_asp's mel branch at 16 kHz, serving
              # (8 utterances x 20 crops) and the train step, crops of 2 s
              ("raw_ecapa 16k", FrontendConfig.from_hparams(
                  dict(RAW_ECAPA_HPARAMS), "melspectrogram"), 8 * 20, 32000),
              ("raw_ecapa 16k train", FrontendConfig.from_hparams(
                  dict(RAW_ECAPA_HPARAMS), "melspectrogram"), 32 * 2, 32000),
              # path G3: ECAPA_TDNN's train step, 128 speakers x 2 crops
              ("ecapa_tdnn 16k train", FrontendConfig.from_hparams(
                  dict(ECAPA_TDNN_HPARAMS), "melspectrogram"), 128 * 2,
               32000),
              # path I4: the Conformer's train step, 64 speakers x 2 crops
              # (model_plot.yaml's frontend is path F's, so I1 and I5
              # serve at the "raw_ecapa 16k" shape)
              ("model_plot 16k train", FrontendConfig.from_hparams(
                  dict(CONFORMER_HPARAMS), "melspectrogram"), 64 * 2,
               32000),
              # an odd window (its centre is n_fft/2 - 1/2): the kernel's
              # unfolded route; no configuration of the repo uses one
              ("raw3_ecapa 8k win201", FrontendConfig(win_length=201),
               8 * 20, 16000)]
    for label, cfg, n_rows, samples in shapes:
        wave = 0.1 * torch.randn(n_rows, samples, generator=gen, device=dev)
        padded = reflect_pad(pre_emphasis(wave), cfg.n_fft // 2).contiguous()
        cs, fb = mel_constants(cfg, dev)
        rows_lo, rows_hi = rows = window_rows(cfg)
        got = mf.mel_frontend(padded, cs, fb, cfg.hop_length, rows)
        ref = mf.mel_frontend_plain(padded, cs, fb, cfg.hop_length, rows)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = 1e-5 * scale   # fp32 sums of up to 512 and 257 terms, other order
        ok = bool(torch.isfinite(got).all()) and err <= tol
        log(f"[K1 {label}] out {tuple(got.shape)} max_abs_err {err:.3e} "
            f"max|ref| {scale:.3e} rel {err / scale:.3e} tol {tol:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"mel kernel disagrees with its plain version ({label})")

        two_k = cs.shape[1]
        K, n_mels = fb.shape
        F = got.shape[1]
        # only the window's basis rows are nonzero; where the window is
        # symmetric about n_fft/2, K1 folds the DFT about it: P = u @ Cf
        # and Q = v @ Sf over win/2 + 1 rows, then the power and the mel
        # product. Any other window takes the unfolded route: the DFT
        # over all win rows
        folded = mf.symmetric(cs, rows)
        c = cfg.n_fft // 2
        depth = max(rows_hi - 1 - c, c - rows_lo) + 1
        win = rows_hi - rows_lo
        unfolded = (2.0 * n_rows * F * (win * two_k + K * n_mels)
                    + 3.0 * n_rows * F * K)
        flops = (2.0 * n_rows * F * (2 * depth * K + K * n_mels)
                 + 3.0 * n_rows * F * K) if folded else unfolded
        nbytes = 4.0 * (padded.numel() + cs.numel() + fb.numel() + got.numel())
        # K1 takes every product as three TF32 tensor-core products
        # (3xTF32); the scalar kernel was held to the fp32 SIMT bound of
        # the unfolded count
        b_ms, b_by = bound_ms(3 * flops, nbytes, PEAK_TF32)
        unfolded_ms, _ = bound_ms(3 * unfolded, nbytes, PEAK_TF32)
        simt_ms, _ = bound_ms(unfolded, nbytes, PEAK_FP32)
        window = torch.hamming_window(cfg.win_length, periodic=True,
                                      device=dev)

        def library():
            spec = torch.stft(padded, cfg.n_fft, cfg.hop_length,
                              cfg.win_length, window=window, center=False,
                              return_complex=True)
            return (spec.abs() ** 2).transpose(1, 2) @ fb

        lib_ref = library()
        lib_err = (lib_ref - ref).abs().max().item()
        res = {
            "name": "mel_frontend", "shape": label,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: mf.mel_frontend(padded, cs, fb,
                                                  cfg.hop_length, rows)),
            "plain_ms": cuda_ms(lambda: mf.mel_frontend_plain(
                padded, cs, fb, cfg.hop_length, rows)),
            "library_ms": cuda_ms(library),
            "bound_ms": b_ms, "bound_by": b_by,
            "unfolded_bound_ms": unfolded_ms,
            "fp32_simt_bound_ms": simt_ms,
            "gflop": flops / 1e9, "route": "folded" if folded else "unfolded",
        }
        log(f"[K1 {label}] kernel {res['ms']:.4f} ms  plain "
            f"{res['plain_ms']:.4f} ms  stft+matmul {res['library_ms']:.4f} ms "
            f"(its max_abs_err vs plain {lib_err:.3e})  kernel/library "
            f"{res['ms'] / res['library_ms']:.3f}")
        log(f"[K1 {label}] bound {b_ms:.4f} ms by {b_by} ({res['route']} DFT, "
            f"{flops / 1e9:.2f} GFLOP, 3xTF32 at 495 TFLOP/s; kernel at "
            f"{b_ms / res['ms']:.1%} of it); unfolded {unfolded / 1e9:.2f} "
            f"GFLOP: 3xTF32 bound {unfolded_ms:.4f} ms, fp32 SIMT bound "
            f"{simt_ms:.4f} ms")
        results.append(res)
    return results


def bf16_close(diff, ref):
    """bf16 outputs of the same sums taken in another order: a rounding
    flip is one ulp of the output and passes, diluted, through the later
    groups. The largest error must stay within 2 bf16 ulps of max|ref|
    and the mean error within 1e-4 of the mean |ref|. The reordering
    alone gives a mean of about 1e-5 of it; leaving out the bf16 rounding
    of the inter-group add gives 2e-3, a bias off by 0.02 gives 5e-3 (CPU
    simulation at these shapes)."""
    import torch
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().max()))) / 128
    worst = (diff.max() / (2 * ulp)).item()
    mean_rel = (diff.mean() / ref.abs().mean()).item()
    return (worst <= 1.0 and mean_rel <= 1e-4,
            f"max err/(2 ulp of max|ref|) {worst:.3f} (<= 1), mean "
            f"err/mean|ref| {mean_rel:.2e} (<= 1e-4)")


def check_cascade_kernel(dev, gen, shapes=((64, 160), (128, 80)),
                         time_every: bool = False):
    """K2 against its plain version at each ``(H, B)`` of ``shapes``
    (default H 64: Raw3_ECAPA's ECAPA branch, 160 crops, and 128:
    ECAPA_TDNN, 80 crops), d 2/3/4, fp32 and bf16; timed at d 2, and at
    d 4 for H 128 fp32, where the halo's recompute is largest (every d
    with ``time_every``); at path B's shape also with 2 to 5 tiles per
    crop."""
    import torch
    import torch.nn.functional as F
    from speakerverification_tpu_torch.ops import res2net_cascade as rc
    results = []
    T, groups = 201, 8
    for hidden, B in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for d in (2, 3, 4):
                C = groups * hidden
                x = torch.randn(B, C, T, generator=gen, device=dev).to(dtype)
                w = torch.randn(groups - 1, 3, hidden, hidden, generator=gen,
                                device=dev) / (3 * hidden) ** 0.5
                cb = 0.1 * torch.randn(groups - 1, hidden, generator=gen,
                                       device=dev)
                s = 0.5 + torch.rand(groups - 1, hidden, generator=gen,
                                     device=dev)
                sh = 0.1 * torch.randn(groups - 1, hidden, generator=gen,
                                       device=dev)
                got = rc.res2net_cascade(x, w, cb, s, sh, dilation=d)
                ref = rc.res2net_cascade_plain(x, w, cb, s, sh, d)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                err = diff.max().item()
                scale = ref.float().abs().max().item()
                tag = f"H{hidden} B{B} d{d} {str(dtype).split('.')[-1]}"
                if dtype == torch.float32:
                    # sums of 3H terms in another order, 7 groups deep
                    tol = 1e-5 * scale
                    ok = err <= tol
                    detail = f"tol {tol:.3e}"
                else:
                    ok, detail = bf16_close(diff, ref.float())
                ok = ok and bool(torch.isfinite(got.float()).all())
                log(f"[K2 {tag}] max_abs_err {err:.3e} max|ref| {scale:.3e} "
                    f"rel {err / scale:.3e} {detail} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"cascade kernel disagrees with its plain version "
                         f"({tag})")
                if d != 2 and not time_every and not (
                        hidden == 128 and d == 4 and dtype == torch.float32):
                    continue
                item = x.element_size()
                flops = 2.0 * B * T * hidden * hidden * 3 * (groups - 1)
                nbytes = (2.0 * B * C * T * item + 4.0 * w.numel()
                          + 3 * 4.0 * cb.numel())
                # fp32 takes every product as three TF32 tensor-core
                # products (3xTF32), bf16 one bf16 product; PR 1's scalar
                # kernel was held to the fp32 SIMT bound
                if dtype == torch.float32:
                    b_ms, b_by = bound_ms(3 * flops, nbytes, PEAK_TF32)
                else:
                    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
                simt_ms, _ = bound_ms(flops, nbytes, PEAK_FP32)
                # the launch's configuration, from the wrapper's schedule
                # (not measured): blocks, shared memory (two weight chunks
                # and the input buffer), the halo's recompute, and an
                # estimate of the weight bytes read from L2 if every block
                # streams every group's packed weights
                table, stride = rc.tile_schedule(
                    B, T, groups, d,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
                w_item = 8 if dtype == torch.float32 else 2   # hi + lo / bf16
                smem = (2 * rc.CHUNK_CHANNELS * hidden * w_item
                        + hidden * stride * (4 if dtype == torch.float32
                                             else 2))
                rows = sum(hi - lo for r in table.tolist()
                           for lo, hi in zip(r[3::2], r[4::2]))
                recompute = rows / (B * T * (groups - 1))
                w_gb = table.shape[0] * w.numel() * w_item / 1e9
                wt = w.to(dtype).permute(0, 3, 2, 1).contiguous()
                cbt = cb.to(dtype)

                def library():
                    outs, y = [x[:, :hidden]], None
                    for i in range(1, groups):
                        c = x[:, i * hidden:(i + 1) * hidden]
                        inp = c if i == 1 else c + y
                        h = F.conv1d(F.pad(inp, (d, d), mode="reflect"),
                                     wt[i - 1], cbt[i - 1], dilation=d)
                        y = torch.relu(h) * s[i - 1, :, None].to(dtype) \
                            + sh[i - 1, :, None].to(dtype)
                        outs.append(y)
                    return torch.cat(outs, 1)

                res = {
                    "name": "res2net_cascade", "shape": tag,
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: rc.res2net_cascade(
                        x, w, cb, s, sh, dilation=d)),
                    "plain_ms": cuda_ms(lambda: rc.res2net_cascade_plain(
                        x, w, cb, s, sh, d)),
                    "library_ms": cuda_ms(library),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "fp32_simt_bound_ms": simt_ms,
                    "gflop": flops / 1e9,
                }
                log(f"[K2 {tag}] kernel {res['ms']:.4f} ms  plain "
                    f"{res['plain_ms']:.4f} ms  conv1d chain "
                    f"{res['library_ms']:.4f} ms  kernel/library "
                    f"{res['ms'] / res['library_ms']:.3f}")
                log(f"[K2 {tag}] bound {b_ms:.4f} ms by {b_by} "
                    f"({flops / 1e9:.2f} GFLOP, "
                    f"{'3xTF32 at 495' if dtype == torch.float32 else 'bf16 at 989'}"
                    f" TFLOP/s; kernel at {b_ms / res['ms']:.1%} of it); fp32 "
                    f"SIMT bound {simt_ms:.4f} ms; {table.shape[0]} blocks of "
                    f"{smem} B shared memory (stride {stride}), halo "
                    f"recompute {recompute:.3f}x, about {w_gb:.3f} GB of "
                    f"weights from L2 (schedule estimate)")
                results.append(res)
                if (hidden, B, d, dtype) == (128, 80, 2, torch.float32):
                    time_tile_counts(rc, (x, w, cb, s, sh), d, tag,
                                     table.shape[0] // B)
    return results


def time_tile_counts(rc, args, d: int, tag: str, picked: int) -> None:
    """K2 at path B's shape with the time tiles per crop forced to 2..5,
    beside the count the wrapper's schedule picks: the measurement behind
    ``tile_count``'s choice."""
    tile_count, times = rc.tile_count, {}
    try:
        for n in (2, 3, 4, 5):
            rc.tile_count = lambda *_, n=n: n
            rc._schedule.cache_clear()
            times[n] = cuda_ms(lambda: rc.res2net_cascade(*args, dilation=d),
                               iters=50)
    finally:
        rc.tile_count = tile_count
        rc._schedule.cache_clear()
    log(f"[K2 {tag} tiles] ms by tiles per crop: "
        + ", ".join(f"{n}: {t:.4f}" for n, t in times.items())
        + f"; the schedule picks {picked}")


def fmt_ms(v) -> str:
    return "n/a" if v is None else f"{v:.4f} ms"


# K3's shapes on path C (Raw3_ECAPA + --quant int8, 160 crops per
# forward): x as the wrapper gets it, N, launches per forward, the layer.
# Path C's forward pre-hooks log the shapes it really launches beside
# this table. The last line is an unaligned shape, not on the path.
QUANT_SHAPES = [
    ((160, 1024, 1575), 1024, 1, "Bottle2neckRaw_0 last 1x1"),
    ((160, 1024, 315), 1024, 2, "Bottle2neckRaw_1 first/last 1x1"),
    ((160, 1024, 105), 1024, 2, "Bottle2neckRaw_2 first/last 1x1"),
    ((160, 3072, 105), 1536, 1, "RawNet3 Conv_0"),
    ((160, 4608, 105), 128, 1, "RawNet3 Conv_1 (attention)"),
    ((160, 512, 201), 512, 6, "ECAPA SE-Res2Net first/last TDNN"),
    ((160, 512, 1), 128, 3, "ECAPA SE first conv"),
    ((160, 1536, 201), 1536, 1, "ECAPA TDNNBlock_1 (MFA)"),
    ((160, 1024), 1024, 3, "AFMS Dense"),
    ((160, 3072), 320, 1, "RawNet3 Dense_0"),
    ((160, 3072), 192, 1, "ECAPA Dense_0"),
    ((70, 96), 50, 0, "unaligned Dense"),
]
HOT_QUANT = "conv 160x1024x1575 N1024 float32"


def quant_label(x_shape, N, dtype) -> str:
    kind = "conv" if len(x_shape) == 3 else "dense"
    return (f"{kind} {'x'.join(map(str, x_shape))} N{N} "
            f"{str(dtype).split('.')[-1]}")


def check_quant_kernel(dev, gen):
    """K3 against its plain version, bit for bit, at every shape of
    ``QUANT_SHAPES`` in fp32 and bf16, each timed beside its plain
    version, the ``torch._int_mm`` chain, the float layer (``F.conv1d``
    or ``F.linear`` in x's dtype, TF32 off), a ``copy_`` that moves x's
    and out's bytes (the card's practical bytes floor) and the bound."""
    import torch
    return [check_quant_shape(dev, gen, x_shape, N, dtype, per_fwd, layer)
            for x_shape, N, per_fwd, layer in QUANT_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]


def check_quant_shape(dev, gen, x_shape, N, dtype, per_fwd, layer,
                      detail: bool = True):
    import torch
    import torch.nn.functional as F
    from speakerverification_tpu_torch.ops import quant_matmul as qm
    label = quant_label(x_shape, N, dtype)
    K = x_shape[1]
    x = torch.randn(*x_shape, generator=gen, device=dev).to(dtype)
    w = torch.randn(N, K, generator=gen, device=dev) / K ** 0.5
    bias = 0.1 * torch.randn(N, generator=gen, device=dev)
    wq, s_w = qm.quantize_weight(w)
    act = 0.9 * x.float().abs().max().item()     # a few inputs saturate
    got = qm.quant_matmul(x, wq, s_w, bias, act)
    ref = qm.quant_matmul_plain(x, wq, s_w, bias, act)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ok = (bool(torch.equal(got, ref))
          and bool(torch.isfinite(got.float()).all()))
    log(f"[K3 {label}] {layer}, {per_fwd} per forward: out "
        f"{tuple(got.shape)} max_abs_err {err:.3e} (bit-exact required) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"int8 GEMM kernel disagrees with its plain version ({label})")

    conv = len(x_shape) == 3
    M = x_shape[0] * x_shape[2] if conv else x_shape[0]
    item = x.element_size()
    flops = 2.0 * M * K * N
    nbytes = M * K * item + K * N + M * N * item
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_INT8)
    s_x, inv_sx = qm.act_scales(act)
    scale = s_w * float(s_x)
    wq_t = wq.T.contiguous()

    def library():
        rows = x.transpose(1, 2).reshape(-1, K) if conv else x
        xq = torch.clamp(torch.round(rows.float() * inv_sx), -127,
                         127).to(torch.int8)
        out = (torch._int_mm(xq, wq_t).float() * scale + bias).to(dtype)
        return (out.reshape(x_shape[0], x_shape[2], N).transpose(1, 2)
                .contiguous() if conv else out)

    wf, bf = w.to(dtype), bias.to(dtype)

    def float_layer():
        if conv:
            return F.conv1d(x, wf[:, :, None], bf)
        return F.linear(x, wf, bf)

    # a copy that reads and writes x's and out's bytes between them
    floor_src = torch.empty((x.nbytes + got.nbytes) // 8, dtype=torch.float32,
                            device=dev)
    floor_dst = torch.empty_like(floor_src)
    # torch._int_mm takes M > 16 and K, N multiples of 8
    lib_ok = M > 16 and K % 8 == 0 and N % 8 == 0
    heavy = nbytes > 2e8
    res = {
        "name": "quant_matmul", "shape": label, "max_abs_err": err,
        "ms": cuda_ms(lambda: qm.quant_matmul(x, wq, s_w, bias, act)),
        "plain_ms": cuda_ms(lambda: qm.quant_matmul_plain(
            x, wq, s_w, bias, act), iters=3 if heavy else 5, warmup=1),
        "library_ms": cuda_ms(library) if lib_ok else None,
        "float_ms": cuda_ms(float_layer),
        "copy_ms": cuda_ms(lambda: floor_dst.copy_(floor_src)),
        "bound_ms": b_ms, "bound_by": b_by, "gop": flops / 1e9,
        "launches_per_forward": per_fwd,
    }
    if detail and conv and x_shape[2] > 1:
        log_quant_trace(qm, label, (x, wq, s_w, bias, act), K, res["ms"])
        time_quant_tiles(qm, label, (x, wq, s_w, bias, act))
    log(f"[K3 {label}] kernel {res['ms']:.4f} ms  plain "
        f"{res['plain_ms']:.4f} ms  _int_mm chain "
        f"{fmt_ms(res['library_ms'])}  float {'conv1d' if conv else 'linear'} "
        f"{fmt_ms(res['float_ms'])}  copy floor {res['copy_ms']:.4f} ms  "
        f"bound {b_ms:.4f} ms by {b_by} (kernel at {b_ms / res['ms']:.1%} "
        f"of it)  {flops / 1e9:.1f} GOP {nbytes / 1e9:.3f} GB")
    return res


def log_quant_trace(qm, label: str, args, K: int, ms: float) -> None:
    """The conv kernel's per-block timeline (thread 0's clock64 cycles),
    averaged over the blocks of one launch: where a block's time goes."""
    import torch
    x, wq = args[0], args[1]
    _, trace = qm.quant_matmul_trace(*args)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, tiles = qm.conv_grid(x.shape[0], wq.shape[0], K, x.shape[2], sms)
    steps = tiles * -(-K // qm.CONV_TILE[2])
    mean = dict(zip(qm.TRACE_FIELDS, trace.double().mean(0).tolist()))
    total = sum(mean.values())
    per_step = ", ".join(f"{k} {mean[k] / steps:.0f}" for k in
                         ("issue", "copy_wait", "quantize", "mma_wait",
                          "product_barrier"))
    log(f"[K3 {label} trace] {tiles} output-channel tiles and {steps} "
        f"steps per block; cycles per block {total:.0f}: prologue "
        f"{mean['prologue']:.0f}, epilogues {mean['epilogue']:.0f} "
        f"({mean['epilogue'] / total:.1%}); per step: {per_step}; "
        f"{trace.shape[0]} blocks, {ms * 1e3 * sms / trace.shape[0]:.1f} µs "
        f"of SM time each")


def time_quant_tiles(qm, label: str, args) -> None:
    """K3 with the output-channel tiles per block forced to each count
    the kernel takes at this shape, beside the count ``conv_grid`` picks:
    the measurement behind its rule."""
    import torch
    x, wq = args[0], args[1]
    nb, K, T = x.shape
    N = wq.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_tiles = -(-N // qm.CONV_TILE[0])
    counts = [g for g in (1, 2, 4) if n_tiles % g == 0]
    if -(-K // qm.CONV_TILE[2]) > qm.RES_STEPS or len(counts) == 1:
        return
    conv_grid, times = qm.conv_grid, {}
    try:
        for g in counts:
            qm.conv_grid = lambda nb_, N_, K_, T_, sms_=132, g=g: (
                (n_tiles // g, -(-T_ // qm.CONV_TILE[1]), nb_), g)
            times[g] = cuda_ms(lambda: qm.quant_matmul(*args))
    finally:
        qm.conv_grid = conv_grid
    log(f"[K3 {label} tiles] ms by output-channel tiles per block: "
        + ", ".join(f"{g}: {t:.4f}" for g, t in times.items())
        + f"; conv_grid picks {conv_grid(nb, N, K, T, sms)[1]}")


def per_forward_k3(k3) -> None:
    """Path C's K3 launches per forward at the table's shapes, summed:
    kernel, bound, copy floor, ``_int_mm`` chain and float layers."""
    for dt in ("float32", "bfloat16"):
        rows = [r for r in k3 if r["shape"].endswith(dt)]

        def total(key, kind=""):
            return sum((r[key] or 0.0) * r["launches_per_forward"]
                       for r in rows if r["shape"].startswith(kind))
        log(f"[K3 per forward {dt}] kernel {total('ms'):.3f} ms (conv "
            f"layout {total('ms', 'conv'):.3f} ms), bound "
            f"{total('bound_ms'):.3f} ms, copy floor {total('copy_ms'):.3f} "
            f"ms, _int_mm chain {total('library_ms'):.3f} ms, float layers "
            f"{total('float_ms'):.3f} ms")


# ----------------------------------------------------------------------
# phase 3-6: the port's paths
# ----------------------------------------------------------------------
def _kernel_modules():
    from speakerverification_tpu_torch.ops import (
        mel_frontend,
        quant_matmul,
        res2net_cascade,
    )
    return {"mel_frontend": mel_frontend, "res2net_cascade": res2net_cascade,
            "quant_matmul": quant_matmul}


def reset_counts():
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def randomize_bn_(model, seed: int) -> None:
    """Random BatchNorm statistics and affines, so that eval-mode BN (and
    the cascade's folded BN) is not the identity."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                for buf, val in (
                        (m.running_mean, 0.1 * torch.randn(n, generator=gen)),
                        (m.running_var, 0.5 + torch.rand(n, generator=gen)),
                        (m.weight, 0.8 + 0.4 * torch.rand(n, generator=gen)),
                        (m.bias, 0.1 * torch.randn(n, generator=gen))):
                    buf.copy_(val.to(buf.device))


def compare_with_cpu(engine, waves, label: str, min_cos: float = 0.9999):
    """Embeddings of one serving batch ``waves`` on the card (the engine's
    path) against the same model's plain path on the CPU. Returns the CPU
    embeddings and the largest row distance ``|got - ref|``."""
    import copy

    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import make_eval_embed_fn
    got = engine.embed_fn(waves).cpu().numpy()
    cpu_model = copy.deepcopy(engine.model).cpu()
    ref = make_eval_embed_fn(cpu_model)(torch.from_numpy(
        np.asarray(waves))).numpy()
    cos = np.sum(got * ref, axis=1) / (np.linalg.norm(got, axis=1)
                                       * np.linalg.norm(ref, axis=1))
    dist = float(np.linalg.norm(got - ref, axis=1).max())
    ok = bool(np.isfinite(got).all()) and float(cos.min()) >= min_cos
    log(f"[{label}] card vs CPU plain path on a serving batch of "
        f"{len(waves)} crops: min cos {cos.min():.7f} (need >= {min_cos}), "
        f"max row distance {dist:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: embeddings on the card disagree with the CPU")
    return ref, dist


def to_wire(crops):
    """Crops as the serving batcher sends them: 16-bit PCM."""
    import numpy as np
    return np.clip(np.round(np.asarray(crops) * 32768.0), -32768,
                   32767).astype(np.int16)


def http(port: int, method: str, path: str, obj=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = None if obj is None else json.dumps(obj)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def serve_over_http(tag: str, model_h: dict, bn_seed: int,
                    device=None) -> dict:
    """A model at full width behind the HTTP serving app (``/healthz``,
    8 concurrent ``/embed``, ``/score``), its replies held against the
    CPU's plain path on the requests' own crops; the mel kernel counted
    once per served batch."""
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer
    import threading

    import numpy as np
    import torch
    from speakerverification_tpu_torch.data.audio import load_wav
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.serving import (
        _pair_cosine,
        _utt_embedding,
        make_serving_app,
    )

    h = {**model_h,
         "serving": {"batch_utts": BATCH_UTTS, "max_wait_ms": 200}}
    engine = InferenceEngine(h, device=device)   # device=None: CUDA
    randomize_bn_(engine.model, seed=bn_seed)
    dim = h["model"]["nOut"]
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[{tag}] {h['model']['name']} on {engine.device}: "
        f"{n_params / 1e6:.2f} M params, frontend_backend auto, "
        f"conv_backend xla (as in JAX)")
    sr = h["audio_spec"]["sample_rate"]
    num_eval = h["num_eval"]
    rng = np.random.default_rng(2)
    # 3 s per request, each with its own tone over noise, so that a reply
    # handed to the wrong request shows
    tt = np.arange(int(3.0 * sr)) / sr
    pcm = [(0.2 * np.sin(2 * np.pi * (150.0 + 170.0 * i) * tt)
            + 0.1 * rng.normal(0, 1, tt.size)).astype(np.float32)
           for i in range(BATCH_UTTS)]

    handler, batcher = make_serving_app(engine, h)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        # warm-up batch outside the counted window (builds, allocator)
        status, _ = http(port, "POST", "/embed", {"pcm": pcm[0].tolist()})
        if status != 200:
            fail(f"warm-up /embed returned {status}")
        batches0 = batcher.batches_run
        reset_counts()
        status, health = http(port, "GET", "/healthz")
        if status != 200 or health.get("status") != "ok":
            fail(f"/healthz returned {status} {health}")
        t0 = time.time()
        with ThreadPoolExecutor(BATCH_UTTS) as ex:
            replies = list(ex.map(lambda x: http(port, "POST", "/embed",
                                                 {"pcm": x.tolist(),
                                                  "sample_rate": sr}), pcm))
        t_embed = time.time() - t0
        status, score = http(port, "POST", "/score",
                             {"enroll": {"pcm": pcm[0].tolist()},
                              "test": {"pcm": pcm[1].tolist()}})
        torch.cuda.synchronize()
        counts = read_counts()
        batches = batcher.batches_run - batches0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=30)

    served = []
    for st, out in replies:
        emb = np.asarray(out.get("embedding", []), np.float64)
        if st != 200 or out.get("dim") != dim or emb.shape != (dim,) \
                or not np.isfinite(emb).all() \
                or abs(np.linalg.norm(emb) - 1.0) > 1e-4:
            fail(f"/embed reply wrong: status {st}, dim {out.get('dim')}")
        served.append(emb)
    if status != 200 or not np.isfinite(score.get("score", np.nan)):
        fail(f"/score returned {status} {score}")
    log(f"[{tag}] /healthz ok; {len(replies)} concurrent /embed: dim {dim}, unit "
        f"norm, finite, {t_embed:.3f} s wall; /score {score['score']:.6f}")
    log(f"[{tag}] launches in the served window: {counts} over {batches} "
        f"batches of up to {BATCH_UTTS}x{num_eval} crops")
    if counts["mel_frontend"] != batches or batches < 2:
        fail(f"path {tag}: mel kernel launched {counts['mel_frontend']} times "
             f"for {batches} batches")
    if counts["res2net_cascade"] != 0 or counts["quant_matmul"] != 0:
        fail(f"path {tag}: the float hybrid ran the cascade or int8 kernel "
             "(conv_backend defaults to xla, no quant)")

    # the requests' own crops, one serving batch, on the card and the CPU
    crops = [load_wav(x, h["audio_spec"], num_eval=num_eval) for x in pcm]
    ref, dist = compare_with_cpu(engine, to_wire(np.concatenate(crops)),
                                 tag)
    ref = ref.reshape(BATCH_UTTS, num_eval, -1)
    utt_ref = np.stack([_utt_embedding(r) for r in ref])      # [U, D]
    cos = np.stack(served) @ utt_ref.T                        # [reply, ref]
    own = np.diag(cos)
    other = np.max(cos - 2 * np.eye(BATCH_UTTS), axis=1)
    ok = own.min() >= 0.9999 and bool(np.all(own > other))
    log(f"[{tag}] each /embed reply vs the CPU mean embedding of its own crops: "
        f"min cos {own.min():.7f} (need >= 0.9999); best other request "
        f"{other.max():.7f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"path {tag}: a served embedding is not its request's")
    # /score's two requests ride in a batch of their own, at its rows:
    # held against the CPU plain path on a batch of that shape.
    # |e1.e2 - e1'.e2'| <= |e1 - e1'| + |e2 - e2'| for unit crop
    # embeddings; twice that, the served batch and the compared one
    # being two runs on the card
    pair, pair_dist = compare_with_cpu(
        engine, to_wire(np.concatenate(crops[:2])), tag)
    pair = pair.reshape(2, num_eval, -1)
    score_ref = _pair_cosine(pair[0], pair[1])
    tol = 4 * pair_dist
    ok = abs(score["score"] - score_ref) <= tol
    log(f"[{tag}] /score {score['score']:.7f} vs CPU pair cosine {score_ref:.7f}: "
        f"diff {abs(score['score'] - score_ref):.3e} (tol {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"path {tag}: /score disagrees with the CPU")
    return {"engine": engine, "counts": counts, "batches": batches,
            "n_crops": BATCH_UTTS * num_eval,
            "samples": int(h["audio_spec"]["sentence_len"] * sr)}


def path_a(card: str) -> dict:
    """Raw3_ECAPA at full width behind the HTTP serving app."""
    return serve_over_http("A", RAW3_ECAPA_HPARAMS, bn_seed=1)


def path_b() -> dict:
    """ECAPA_TDNN at 1024 channels with the cascade kernel, one batch."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine

    h = {**ECAPA_TDNN_HPARAMS,
         "model": {**ECAPA_TDNN_HPARAMS["model"], "conv_backend": "pallas"}}
    engine = InferenceEngine(h)
    randomize_bn_(engine.model, seed=3)
    n = BATCH_UTTS * h["num_eval"]
    samples = int(h["audio_spec"]["sentence_len"]
                  * h["audio_spec"]["sample_rate"])
    waves = (0.1 * np.random.default_rng(4).normal(0, 1, (n, samples))
             ).astype(np.float32)
    engine.embed_fn(waves)                        # warm-up
    torch.cuda.synchronize()
    reset_counts()
    emb = engine.embed_fn(waves)
    torch.cuda.synchronize()
    counts = read_counts()
    emb = emb.cpu().numpy()
    if emb.shape != (n, 192) or not np.isfinite(emb).all() \
            or np.abs(np.linalg.norm(emb, axis=1) - 1.0).max() > 1e-4:
        fail(f"path B embeddings wrong: shape {emb.shape}")
    log(f"[B] ECAPA_TDNN 1024 conv_backend pallas: {n} crops -> {emb.shape}, "
        f"unit norm, finite; launches per forward {counts}")
    if counts != {"mel_frontend": 1, "res2net_cascade": 3, "quant_matmul": 0}:
        fail(f"path B: expected 1 mel and 3 cascade launches, got {counts}")
    compare_with_cpu(engine, waves, "B")
    return {"engine": engine, "counts": counts, "waves": waves, "n_crops": n}


def cosines(a, b):
    import numpy as np
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


def write_trial_data(root, sr: int, n_spk: int = 4, n_utt: int = 4,
                     n_trials: int = 40, f0_step: float = 70.0
                     ) -> tuple[list, str]:
    """``n_spk`` speakers x ``n_utt`` utterances of 3 s (a speaker's
    harmonic tone over noise) as 16-bit WAVs, and ``n_trials`` trials
    over them, target and non-target in turn."""
    import numpy as np
    from speakerverification_tpu_torch.data.audio import write_wav
    rng = np.random.default_rng(6)
    tt = np.arange(int(3.0 * sr)) / sr
    files = {}
    for spk in range(n_spk):
        for utt in range(n_utt):
            f0 = 110.0 + f0_step * spk
            sig = sum(0.25 / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * tt
                                              + rng.uniform(0, 6))
                      for k in range(3)) + 0.05 * rng.normal(0, 1, tt.size)
            path = root / "wav" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), sr)
            files.setdefault(spk, []).append(str(path))
    lines = []
    for i in range(n_trials):
        s1 = int(rng.integers(n_spk))
        if i % 2 == 0:
            a, b = rng.choice(n_utt, 2, replace=False)
            lines.append(f"1 {files[s1][a]} {files[s1][b]}")
        else:
            s2 = int((s1 + 1 + rng.integers(n_spk - 1)) % n_spk)
            lines.append(f"0 {files[s1][int(rng.integers(n_utt))]} "
                         f"{files[s2][int(rng.integers(n_utt))]}")
    trials = root / "trials.txt"
    trials.write_text("\n".join(lines) + "\n")
    return sorted(p for v in files.values() for p in v), str(trials)


def read_scores(h):
    import numpy as np
    from speakerverification_tpu_torch.inference import run_dirs
    rows = (run_dirs(h)["result"] / "evaluation_results.csv").read_text()
    return np.array([float(r.split(",")[1])
                     for r in rows.strip().splitlines()[1:]])


def path_c(tmp) -> dict:
    """Offline trial evaluation of Raw3_ECAPA at full width with int8
    extraction: the ``--do_infer --eval --quant int8`` verb."""
    import copy

    import numpy as np
    import torch
    from speakerverification_tpu_torch.builder import encoder_from_hparams
    from speakerverification_tpu_torch.data.loader import EvalDataLoader
    from speakerverification_tpu_torch.inference import (
        InferenceEngine,
        inference,
    )
    from speakerverification_tpu_torch.quant import make_int8_embed_fn
    from speakerverification_tpu_torch.weights import init_weights_

    sr = RAW3_ECAPA_HPARAMS["audio_spec"]["sample_rate"]
    num_eval = RAW3_ECAPA_HPARAMS["num_eval"]
    files, trials = write_trial_data(tmp, sr)
    # random weights from the seed with random BN, as a port weights file
    model = encoder_from_hparams(RAW3_ECAPA_HPARAMS)
    init_weights_(model, torch.Generator().manual_seed(
        RAW3_ECAPA_HPARAMS["seed"]))
    randomize_bn_(model, seed=5)
    weights = tmp / "raw3_ecapa.pt"
    torch.save(model.state_dict(), weights)
    h = {**RAW3_ECAPA_HPARAMS, "quant": "int8", "eval_batch_size": BATCH_UTTS,
         "evaluation_file": trials, "save_folder": str(tmp / "save"),
         "initial_model_infer": str(weights),
         "dataloader_options": {"num_workers": 4}}
    batches = -(-len(files) // BATCH_UTTS)

    reset_counts()
    t0 = time.time()
    with quant_shape_log() as shapes:
        report = inference(h, eval_=True)["eval"]
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    log_quant_shapes(shapes, batches)
    int8_scores = read_scores(h)
    log(f"[C] eval of {len(int8_scores)} trials over "
        f"{len(files)} files ({batches} batches of {BATCH_UTTS}x{num_eval} "
        f"crops), int8: {wall:.2f} s wall; EER {report['eer']:.4f}% "
        f"minDCF {report['min_dcf']:.4f} thr {report['threshold']:.4f}")
    log(f"[C] launches in the eval run: {counts}")
    # the first batch also runs the float model once, on the 32 rows that
    # calibrate the static scales: one more mel launch
    want = {"mel_frontend": batches + 1, "res2net_cascade": 0,
            "quant_matmul": 22 * batches}
    if counts != want:
        fail(f"path C: expected {want}, got {counts}")
    finite = all(np.isfinite(report[k]) for k in
                 ("eer", "min_dcf", "threshold", "auc"))
    if not finite or len(int8_scores) != 40 \
            or not np.isfinite(int8_scores).all():
        fail(f"path C: report or scores not finite / incomplete: {report}")

    inference({**h, "quant": None}, eval_=True)
    diff = np.abs(int8_scores - read_scores(h))
    log(f"[C] per-trial |int8 - float| score: max {diff.max():.3e} mean "
        f"{diff.mean():.3e} over {len(diff)} trials")

    # one loader batch on the card (the engine calibrates on it) against
    # the same engine's plain int8 path on the CPU with the same scales,
    # trimmed to two files to bound the CPU time
    engine = InferenceEngine(h)
    waves, _ = next(iter(EvalDataLoader(files, h["audio_spec"],
                                        num_eval=num_eval,
                                        batch_size=BATCH_UTTS)))
    batch = waves.reshape(-1, waves.shape[-1])
    got = engine.embed_fn(batch).cpu().numpy()
    cpu = make_int8_embed_fn(copy.deepcopy(engine.model).cpu(),
                             act_scales=engine.act_scales)
    n_cpu = 2 * num_eval
    ref = cpu(torch.from_numpy(batch[:n_cpu])).numpy()
    cos = cosines(got[:n_cpu], ref)
    ok = bool(np.isfinite(got).all()) and cos.min() >= 0.999
    log(f"[C] int8 on the card vs the plain int8 path on the CPU, same "
        f"scales, {n_cpu} crops: min cos {cos.min():.7f} (need >= 0.999) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path C: int8 embeddings on the card disagree with the CPU")
    float_engine = InferenceEngine({**h, "quant": None})
    cos = cosines(got, float_engine.embed_fn(batch).cpu().numpy())
    ok = cos.min() >= 0.99
    log(f"[C] int8 vs float embeddings on the card, {len(batch)} crops: "
        f"min cos {cos.min():.5f}, mean {cos.mean():.5f} (need >= 0.99) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path C: int8 embeddings stray from the float path")
    eval_at_list_size(engine, h, tmp / "vox1o")
    return {"engine": engine, "counts": counts, "batches": batches,
            "waves": batch, "h": h}


@contextlib.contextmanager
def quant_shape_log():
    """Record, by a forward pre-hook on every module, the kernel shape
    of each ``QuantConv1d``/``QuantLinear`` call: ``{(x shape, N,
    dtype): calls}``, x as K3's wrapper gets it (conv columns after
    padding and im2col, Dense rows flattened)."""
    import collections

    import torch
    from speakerverification_tpu_torch.quant import QuantConv1d, QuantLinear
    shapes = collections.Counter()

    def hook(mod, inputs):
        x = inputs[0]
        if isinstance(mod, QuantConv1d) and x.dim() == 3:
            t_out = x.shape[2] + sum(mod.pad) - mod.d * (mod.k - 1)
            shape = (x.shape[0], mod.k * x.shape[1], t_out)
        elif isinstance(mod, QuantLinear) and x.dim() >= 2:
            shape = (x.numel() // x.shape[-1], x.shape[-1])
        else:
            return
        shapes[(shape, mod.wq.shape[0], str(x.dtype).split(".")[-1])] += 1

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield shapes
    finally:
        handle.remove()


def log_quant_shapes(shapes, forwards: int, table=None,
                     tag: str = "C") -> bool:
    """The logged shapes per forward against ``table`` (default
    ``QUANT_SHAPES``); whether they match."""
    rows = QUANT_SHAPES if table is None else table
    want = {(tuple(s), n): per for s, n, per, _ in rows if per}
    seen = {}
    for (shape, n, dtype), calls in sorted(shapes.items()):
        seen[(tuple(shape), n)] = seen.get((tuple(shape), n), 0) + calls
        log(f"[{tag} shapes] x {list(shape)} N {n} {dtype}: "
            f"{calls / forwards:g} per forward")
    per_fwd = {k: v / forwards for k, v in seen.items()}
    log(f"[{tag} shapes] {'match' if per_fwd == want else 'DIFFER FROM'} "
        f"the table ({sum(per_fwd.values()):g} launches per forward)")
    return per_fwd == want


def path_c_bf16(c: dict, card: str) -> None:
    """Path C's model with ``mixedprec: true`` (bf16 parameters and
    activations, frontend in fp32), float against int8 on one eval batch:
    launches, int8-vs-float cosine, throughput and a profile of each."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    h = {**c["h"], "mixedprec": True}
    waves = c["waves"]
    int8 = InferenceEngine(h)
    int8.embed_fn(waves)                  # calibrates on this batch
    torch.cuda.synchronize()
    reset_counts()
    got = int8.embed_fn(waves)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {"mel_frontend": 1, "res2net_cascade": 0, "quant_matmul": 22}
    log(f"[C bf16] launches per int8 forward: {counts}")
    if counts != want:
        fail(f"path C bf16: expected {want}, got {counts}")
    flt = InferenceEngine({**h, "quant": None})
    cos = cosines(got.cpu().numpy(), flt.embed_fn(waves).cpu().numpy())
    ok = bool(np.isfinite(got.cpu().numpy()).all()) and cos.min() >= 0.99
    log(f"[C bf16] int8 vs float embeddings, both bf16, {len(waves)} crops: "
        f"min cos {cos.min():.5f}, mean {cos.mean():.5f} (need >= 0.99) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path C bf16: int8 embeddings stray from the float path")
    num_eval = RAW3_ECAPA_HPARAMS["num_eval"]
    throughput("C bf16 float", flt, waves, num_eval, card)
    throughput("C bf16 int8", int8, waves, num_eval, card)
    profile("C bf16 float", flt, waves)
    profile("C bf16 int8", int8, waves)


# ----------------------------------------------------------------------
# path D: checkpoints, the verbs and the speaker banks
# ----------------------------------------------------------------------
def seeded_model(seed: int):
    """Full-width Raw3_ECAPA with random weights and BN from ``seed``."""
    import torch
    from speakerverification_tpu_torch.builder import encoder_from_hparams
    from speakerverification_tpu_torch.weights import init_weights_
    model = encoder_from_hparams(RAW3_ECAPA_HPARAMS)
    init_weights_(model, torch.Generator().manual_seed(seed))
    randomize_bn_(model, seed=seed + 1)
    return model


def flax_tree(model, seed: int):
    """The model's weights as the JAX trainer's checkpoint holds them,
    beside a loss head's ``W`` (read and not restored by the port)."""
    import numpy as np
    from speakerverification_tpu_torch.weights import params_to_jax
    params, stats = params_to_jax(model.state_dict())
    params["loss"] = {"W": np.random.default_rng(seed).normal(
        0, 0.05, (512, 100)).astype(np.float32)}
    return params, stats


def state_equal(engine, params, stats) -> bool:
    """Whether the engine serves exactly these flax trees."""
    import torch
    from speakerverification_tpu_torch.weights import params_from_jax
    want = params_from_jax({"backbone": params["backbone"]},
                           {"backbone": stats["backbone"]})
    got = engine.model.state_dict()
    return all(torch.equal(got[k].cpu(), want[k]) for k in got
               if not k.endswith("num_batches_tracked"))


def write_checkpoints(model_dir) -> dict:
    """best_state, a different last_state, best_state_top{1,2,3} and an
    EMA checkpoint of full-width Raw3_ECAPA, in the JAX trainer's msgpack
    layout, written by the port; returns the trees."""
    import numpy as np
    from speakerverification_tpu_torch.checkpoint import save_checkpoint

    def state(params, stats, opt_state=None):
        return {"step": np.asarray(100, np.int32), "params": params,
                "batch_stats": stats, "opt_state": opt_state or {}}

    best_model = seeded_model(31)
    best = flax_tree(best_model, 31)
    trees = {"best": best, "model": best_model}
    t0 = time.time()
    save_checkpoint(model_dir / "best_state.msgpack", state(*best),
                    {"epoch": 3, "loss": 1.5})
    last = flax_tree(seeded_model(41), 41)
    save_checkpoint(model_dir / "last_state.msgpack", state(*last),
                    {"epoch": 4, "loss": 1.7})
    trees["top"] = []
    for i in (1, 2, 3):
        top = flax_tree(seeded_model(50 + i), 50 + i)
        save_checkpoint(model_dir / f"best_state_top{i}.msgpack",
                        state(*top), {"epoch": 4 - i})
        trees["top"].append(top)
    ema_params, _ = flax_tree(seeded_model(61), 61)
    trees["ema"] = (ema_params, best[1])
    # an optax chain is stored as a dict with index keys; track_ema last
    save_checkpoint(model_dir.parent / "ema_state.msgpack",
                    state(*best, {"0": {}, "1": {"ema": ema_params}}))
    size = (model_dir / "best_state.msgpack").stat().st_size
    log(f"[D] wrote 6 msgpack checkpoints of full-width Raw3_ECAPA "
        f"({size / 1e6:.1f} MB each) in {time.time() - t0:.2f} s")
    return trees


def check_checkpoints(h, trees, waves) -> dict:
    """The engine picks, loads, averages and EMA-loads the JAX-layout
    checkpoints; the file's embeddings are the model's."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import (
        InferenceEngine,
        _select_weights,
        make_eval_embed_fn,
        run_dirs,
    )
    model_dir = run_dirs(h)["model"]
    picked = _select_weights(h, model_dir)
    if picked != model_dir / "best_state.msgpack":
        fail(f"path D: _select_weights picked {picked}, not best_state")
    t0 = time.time()
    engine = InferenceEngine(h)
    t_load = time.time() - t0
    if not state_equal(engine, *trees["best"]):
        fail("path D: the engine's weights differ from best_state's")
    ref_fn = make_eval_embed_fn(trees["model"].to(engine.device))
    got, ref = engine.embed_fn(waves), ref_fn(torch.from_numpy(waves))
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref))
    diff = (got - ref).abs().max().item()
    ok = same or diff <= 1e-6
    log(f"[D] _select_weights -> {picked.name}; engine built and loaded in "
        f"{t_load:.2f} s; weights bit-identical to the model written; "
        f"embeddings of {len(waves)} crops from the file vs the model: "
        f"torch.equal {same}, max |diff| {diff:.3e} (bound 1e-6) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path D: embeddings from the checkpoint differ from the model's")
    trees["model"].cpu()

    soup = InferenceEngine({**h, "average_checkpoints": True,
                            "use_ema": True})
    mean = {}
    for part in (0, 1):
        mean[part] = {}
        flat = [t[part]["backbone"] for t in trees["top"]]

        def avg(*xs):
            if isinstance(xs[0], dict):
                return {k: avg(*(x[k] for x in xs)) for k in xs[0]}
            return (sum(np.asarray(x, np.float32) for x in xs)
                    / np.float32(len(xs)))
        mean[part] = {"backbone": avg(*flat)}
    ok = state_equal(soup, mean[0], mean[1])
    log(f"[D] average_checkpoints (with use_ema, which it ignores): "
        f"{soup.weights_path.name} + 2, weights equal the fp32 mean of the "
        f"three bit for bit {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path D: the soup is not the mean of best_state_top{1,2,3}")
    del soup
    ema_path = model_dir.parent / "ema_state.msgpack"
    ema = InferenceEngine({**h, "initial_model_infer": str(ema_path),
                           "use_ema": True})
    raw = InferenceEngine({**h, "use_ema": True})    # best_state: no EMA
    ok = (state_equal(ema, *trees["ema"])
          and state_equal(raw, *trees["best"]))
    log(f"[D] use_ema: the EMA subtree of opt_state served; on a checkpoint "
        f"without one the raw weights {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path D: use_ema served the wrong weights")
    return {"engine": engine, "load_s": t_load}


def write_speakers(root, sr: int, n_spk: int = 16, seconds: float = 3.0):
    """``n_spk`` speaker folders of one WAV each (a harmonic tone over
    noise per speaker), and a train list of them."""
    import numpy as np
    from speakerverification_tpu_torch.data.audio import write_wav
    rng = np.random.default_rng(21)
    tt = np.arange(int(seconds * sr)) / sr
    files = []
    for spk in range(n_spk):
        f0 = 95.0 + 37.0 * spk
        sig = sum(0.25 / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * tt
                                          + rng.uniform(0, 6))
                  for k in range(3)) + 0.05 * rng.normal(0, 1, tt.size)
        path = root / "speakers" / f"spk{spk:02d}" / "u0.wav"
        write_wav(path, sig.astype(np.float32), sr)
        files.append(str(path))
    train = root / "train_list.txt"
    train.write_text("".join(f"spk{i:02d} {f}\n" for i, f in enumerate(files)))
    return files, str(root / "speakers"), str(train)


def timed(label: str, fn):
    import torch
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    log(f"[D wall] {label}: {wall:.3f} s")
    return out, wall


def run_verbs(h, tmp, files, data_folder, train) -> dict:
    """``inference()`` with prepare (embed, then cohorts), eval and test
    with S-norm on those cohorts, and predict on the enrolled files."""
    import numpy as np
    from speakerverification_tpu_torch.inference import inference, run_dirs
    walls = {}
    _, walls["prepare embed"] = timed("prepare (embed, 16 speakers)", lambda: (
        inference({**h, "prepare": "embed", "data_folder": data_folder},
                  prepare=True)))
    mdir = run_dirs(h)["model"]
    embeds = np.load(mdir / "embeds.npy")
    classes = np.load(mdir / "classes.npy", allow_pickle=True).item()
    if embeds.shape != (16, 512) or not np.isfinite(embeds).all() \
            or sorted(classes.values()) != [f"spk{i:02d}" for i in range(16)]:
        fail(f"path D: prepare embed wrote {embeds.shape} {classes}")
    cohorts = str(tmp / "cohorts.npy")
    _, walls["prepare cohorts"] = timed("prepare (cohorts, 16 speakers)", (
        lambda: inference({**h, "prepare": "cohorts", "train_annotation": train,
                           "cohorts_path": cohorts}, prepare=True)))
    if np.load(cohorts).shape != (16, 512):
        fail("path D: prepare cohorts wrote a wrong bank")
    sr = h["audio_spec"]["sample_rate"]
    _, trials = write_trial_data(tmp / "trials", sr)
    hn = {**h, "scoring_mode": "norm", "cohorts_path": cohorts,
          "evaluation_file": trials, "verification_file": trials,
          "test_threshold": 0}
    out, walls["eval norm"] = timed("eval (S-norm, 40 trials)",
                                    lambda: inference(hn, eval_=True))
    rep = out["eval"]
    rows = read_scores(hn)
    if rep["n_trials"] != 40 or len(rows) != 40 \
            or not np.isfinite(rows).all() or not np.isfinite(rep["eer"]):
        fail(f"path D: eval with S-norm incomplete: {rep}")
    log(f"[D] eval, S-norm on the prepared cohorts: EER {rep['eer']:.4f}% "
        f"minDCF {rep['min_dcf']:.4f} over {rep['n_trials']} trials")
    out, walls["test"] = timed("test (threshold 0: tuned on the eval list "
                               "first, S-norm)", lambda: inference(hn, test=True))
    rep = out["test"]
    lines = open(rep["output"]).read().strip().splitlines()
    log_text = (run_dirs(h)["result"] / "Testing_log.txt").read_text()
    if len(lines) != 40 or rep["n"] != 40 or "precision" not in log_text \
            or rep["threshold"] == 0:
        fail(f"path D: test wrote {len(lines)} lines, report {rep}")
    log(f"[D] test: {len(lines)} result lines, threshold "
        f"{rep['threshold']:.4f}, accuracy {rep['accuracy']:.4f}, "
        f"classification report in Testing_log.txt")
    out, walls["predict"] = timed("predict (16 files)", lambda: inference(
        h, predict=files))
    pred = out["predict"]
    own = [(name, score) for (name, score), f in zip(pred, files)
           if name == f.split("/")[-2]]
    worst = min(score for _, score in pred)
    ok = len(own) == 16 and worst >= 0.9999
    log(f"[D] predict on the enrolled files: {len(own)}/16 name their own "
        f"speaker, min score {worst:.7f} (need >= 0.9999) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"path D: predict named {pred}")
    return {"walls": walls, "embeds": embeds, "classes": classes}


def http_banks(h, engine, files, tmp) -> dict:
    """The HTTP app on the prepared bank, on the card: /identify,
    /enroll, /identify, /unenroll, and the artifacts on disk."""
    from http.server import ThreadingHTTPServer
    import threading

    import numpy as np
    import torch
    from speakerverification_tpu_torch.data.audio import write_wav
    from speakerverification_tpu_torch.inference import run_dirs
    from speakerverification_tpu_torch.serving import make_serving_app

    hs = {**h, "serving": {"batch_utts": BATCH_UTTS, "max_wait_ms": 2,
                           "device_bank": True}}
    handler, batcher = make_serving_app(engine, hs)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    sr = h["audio_spec"]["sample_rate"]
    tt = np.arange(3 * sr) / sr
    newcomer = tmp / "newcomer.wav"
    write_wav(newcomer, (0.3 * np.sign(np.sin(2 * np.pi * 77.0 * tt))
                         + 0.05 * np.random.default_rng(5).normal(
                             0, 1, tt.size)).astype(np.float32), sr)
    try:
        status, out = http(port, "POST", "/identify", {"path": files[3]})
        if status != 200 or out.get("speaker") != "spk03":
            fail(f"path D: /identify of spk03's file gave {status} {out}")
        lat = []
        for f in files[:8]:
            t0 = time.time()
            status, out = http(port, "POST", "/identify",
                               {"path": f, "k": 5})
            lat.append(time.time() - t0)
            if status != 200 or out["speaker"] != f.split("/")[-2] \
                    or len(out.get("candidates", [])) != 5:
                fail(f"path D: /identify k=5 of {f} gave {status} {out}")
        bank = handler.banks["device"]
        if bank is None or bank.device != engine.device:
            fail("path D: the served bank is not on the engine's card")
        status, out = http(port, "POST", "/enroll",
                           {"path": str(newcomer), "name": "newcomer"})
        if status != 200 or out != {"speaker": "newcomer", "index": 16,
                                    "enrolled": 17}:
            fail(f"path D: /enroll gave {status} {out}")
        status, out = http(port, "POST", "/identify", {"path": str(newcomer)})
        if status != 200 or out["speaker"] != "newcomer":
            fail(f"path D: /identify of the newcomer gave {status} {out}")
        mdir = run_dirs(h)["model"]
        on_disk = np.load(mdir / "embeds.npy")
        if len(on_disk) != 17:
            fail("path D: /enroll did not persist the bank")
        status, out = http(port, "POST", "/unenroll", {"name": "newcomer"})
        if status != 200 or out != {"speaker": "newcomer", "enrolled": 16}:
            fail(f"path D: /unenroll gave {status} {out}")
        embeds = np.load(mdir / "embeds.npy")
        classes = np.load(mdir / "classes.npy", allow_pickle=True).item()
        rows = bank._bank[:bank.n].float().cpu().numpy()
        norm = embeds / np.linalg.norm(embeds, axis=1, keepdims=True)
        ok = (bank.n == 16 and classes == handler.banks["classes"]
              and classes == bank._labels
              and np.array_equal(embeds, handler.banks["embeds"])
              and np.abs(rows - norm).max() <= 1e-6)
        log(f"[D] HTTP on the prepared bank (SpeakerBank on "
            f"{bank.device}): /identify of an enrolled file names it; "
            f"/enroll newcomer -> index 16, /identify finds it, /unenroll "
            f"removes it; embeds.npy/classes.npy reloaded from disk match "
            f"the bank (max row diff {np.abs(rows - norm).max():.2e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("path D: the persisted artifacts disagree with the bank")
        torch.cuda.synchronize()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=30)
    ms = [1e3 * t for t in lat]
    log(f"[D] /identify over HTTP (k=5, one request at a time, a 3 s WAV "
        f"read on the server, 16-speaker bank on the card): mean "
        f"{np.mean(ms):.2f} ms, min {min(ms):.2f}, max {max(ms):.2f} over "
        f"{len(ms)} requests")
    return {"identify_ms": ms}


def bank_at_scale(dev, planted_rows, card: str, N: int = 1_000_000) -> list:
    """A bank of 1,000,000 seeded unit rows x 512 dims made on the card,
    with path D's embeddings and 144 seeded unit rows planted at known
    indices: identify at Q 1 and 160, k 1 and 10, fp32 and bf16, against
    the planted indices and the CPU product; ms per identify against the
    bound; an add of 1,000 rows and one remove."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.evaluation.bank import SpeakerBank
    D, Q = 512, 160
    gen = torch.Generator(device=dev).manual_seed(71)
    rows = torch.randn(N, D, generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    extra = torch.randn(Q - len(planted_rows), D, generator=gen, device=dev)
    queries = torch.cat([torch.as_tensor(planted_rows, device=dev).float(),
                         extra])
    queries /= queries.norm(dim=1, keepdim=True)
    where = torch.randperm(N, generator=gen, device=dev)[:Q]
    rows[where] = queries
    where_np = where.cpu().numpy()
    qn = queries.cpu().numpy()
    # planted rows closer than this to another planted row may tie with
    # it in bf16 (its scores near 1 are 2^-8 apart)
    sim = qn @ qn.T - 2 * np.eye(Q)
    separated = sim.max(axis=1) < 0.99
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.time()
        bank = SpeakerBank(rows, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        name = str(dtype).split(".")[-1]
        for q, k in ((1, 1), (1, 10), (Q, 1), (Q, 10)):
            s, i = bank.identify(queries[:q], k=k)
            top = i[:, 0] == where_np[:q]
            # fp32 finds every planted row first; bf16 those that are well
            # separated, and for the rest another planted row within its
            # resolution (random weights make path D's embeddings close)
            need = np.ones(q, bool) if dtype == torch.float32 \
                else separated[:q]
            near = np.isin(i[:, 0], where_np) & (s[:, 0] >= 1 - 2 ** -7)
            rows_ok = top | (~need & near)
            got_rows = bank._bank[torch.as_tensor(i.reshape(-1), device=dev)]
            ref = np.einsum("qkd,qd->qk", got_rows.float().cpu().numpy()
                            .reshape(q, k, D),
                            queries[:q].to(dtype).float().cpu().numpy())
            err = np.abs(ref - s).max()
            tol = 1e-5 if dtype == torch.float32 else 2 ** -8
            ok = bool(rows_ok.all() and err <= tol)
            item = 4 if dtype == torch.float32 else 2
            nbytes = N * D * item + q * D * 4 + q * k * 12
            peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
            b_ms, b_by = bound_ms(2.0 * q * N * D, nbytes, peak)
            ms = cuda_ms(lambda: bank.identify(queries[:q], k=k), iters=10)
            log(f"[D bank {name} Q{q} k{k}] planted index first for "
                f"{int(top.sum())}/{q} (need {int(need.sum())}, the others "
                f"a planted row at >= 1 - 2^-7: {int(rows_ok.sum())}/{q}); "
                f"top-k scores vs "
                f"the CPU product on the same rows: max |diff| {err:.2e} "
                f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
            log(f"[D bank {name} Q{q} k{k}] {ms:.4f} ms per identify, bound "
                f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.3f} GB at 3.35 TB/s, "
                f"{2.0 * q * N * D / 1e9:.1f} GFLOP at "
                f"{peak / 1e12:.0f} TFLOP/s; at {b_ms / ms:.1%} of it); bank "
                f"built in {t_build:.3f} s ({card})")
            if not ok:
                fail(f"path D: the 1M-row {name} bank missed planted rows")
            results.append({"dtype": name, "Q": q, "k": k, "ms": ms,
                            "bound_ms": b_ms, "bound_by": b_by})
            if (q, k) in ((1, 1), (Q, 10)):
                profile(f"D bank {name} Q{q} k{k}", None, None, top=6,
                        fn=lambda: bank.identify(queries[:q], k=k))
        new = torch.randn(1000, D, generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        idx = bank.add(new)
        torch.cuda.synchronize()
        t_add = time.time() - t0
        t0 = time.time()
        bank.remove(int(idx[0]))
        torch.cuda.synchronize()
        t_remove = time.time() - t0
        log(f"[D bank {name}] add of 1,000 rows {1e3 * t_add:.3f} ms (grows "
            f"{N} -> {bank.n_pad} padded rows), one remove "
            f"{1e3 * t_remove:.3f} ms; {bank.nbytes / 1e9:.3f} GB on the card")
        if bank.n != N + 999:
            fail("path D: add/remove left a wrong row count")
        del bank
        torch.cuda.empty_cache()
    return results


def path_d(tmp, card: str) -> dict:
    """Full-width Raw3_ECAPA from JAX-layout checkpoints through the
    inference verbs and the speaker banks: ``inference(prepare=...)``,
    ``eval``/``test`` with S-norm, ``predict``, the HTTP bank routes and
    a 1M-row bank."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import run_dirs
    sr = RAW3_ECAPA_HPARAMS["audio_spec"]["sample_rate"]
    h = {**RAW3_ECAPA_HPARAMS, "save_folder": str(tmp / "save"),
         "eval_batch_size": BATCH_UTTS,
         "dataloader_options": {"num_workers": 4}}
    trees = write_checkpoints(run_dirs(h)["model"])
    files, data_folder, train = write_speakers(tmp, sr)
    from speakerverification_tpu_torch.data.loader import EvalDataLoader
    waves, _ = next(iter(EvalDataLoader(files, h["audio_spec"],
                                        num_eval=h["num_eval"],
                                        batch_size=BATCH_UTTS)))
    waves = waves.reshape(-1, waves.shape[-1])
    ck = check_checkpoints(h, trees, waves)
    reset_counts()
    verbs = run_verbs(h, tmp, files, data_folder, train)
    served = http_banks(h, ck["engine"], files, tmp)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[D] launches over the verbs and the HTTP exchange: {counts}")
    if counts["mel_frontend"] < 1 or counts["res2net_cascade"] != 0 \
            or counts["quant_matmul"] != 0:
        fail(f"path D: expected mel launches only, got {counts}")
    compare_with_cpu(ck["engine"], waves, "D")
    bank = bank_at_scale(torch.device("cuda", 0), verbs["embeds"], card)
    return {"counts": counts, "walls": verbs["walls"], "bank": bank,
            "identify_ms": served["identify_ms"], "engine": ck["engine"],
            "waves": waves}


# C's list as a share of VoxCeleb1-O's size (the whole script: half)
C_LIST_SHARE = 1.0


def eval_at_list_size(engine, h, root) -> None:
    """Time the eval verb of an int8 engine that is already calibrated
    and built on a trial list of VoxCeleb1-O's size (40 speakers, 4,874
    files, 37,720 trials; here 40 x 122 = 4,880 synthetic 3 s files, or
    ``C_LIST_SHARE`` of them and of the trials): the wall of
    ``engine.evaluate`` (decode, extraction, scoring, the CSV), per batch
    and per file, set-up and calibration left out; the lists per
    GPU-hour are of VoxCeleb1-O's size, at the measured files/s."""
    import numpy as np
    n_utt, n_trials = (round(122 * C_LIST_SHARE),
                       round(37720 * C_LIST_SHARE))
    t0 = time.time()
    files, trials = write_trial_data(root, h["audio_spec"]["sample_rate"],
                                     n_spk=40, n_utt=n_utt,
                                     n_trials=n_trials, f0_step=15.0)
    t_write = time.time() - t0
    report = engine.evaluate(trials)
    with open(trials) as f:
        n_files = len({p for ln in f for p in ln.split()[1:]})
    batches = -(-n_files // BATCH_UTTS)
    sec = report["seconds"]
    if report["n_trials"] != n_trials or not np.isfinite(report["eer"]):
        fail(f"path C at list size: incomplete or not finite: {report}")
    log(f"[C list size] {report['n_trials']} trials over {n_files} files "
        f"({batches} batches of {BATCH_UTTS}x{h['num_eval']} crops), int8, "
        f"engine calibrated and built: {sec:.3f} s wall "
        f"({1e3 * sec / batches:.2f} ms per batch, {n_files / sec:.1f} "
        f"files/s, {3600 / (sec * 4880 / n_files):.1f} lists of "
        f"VoxCeleb1-O's size per GPU-hour); WAVs written in {t_write:.1f} s "
        f"beforehand")


def throughput(label: str, engine, waves, num_eval: int, card: str) -> None:
    import torch
    ms = cuda_ms(lambda: engine.embed_fn(waves), iters=10, warmup=2)
    crops = waves.shape[0]
    log(f"[{label} throughput] {crops} crops per forward: {ms:.2f} ms -> "
        f"{crops / ms * 1e3:.1f} embeddings/s, "
        f"{crops / num_eval / ms * 1e3:.1f} utterances/s ({card})")


# calls per profile: the profiler's event tables take host CPU time in
# proportion to the operators profiled (7.2 s for one call of ~14,000
# small CPU operators on an 8-core host, 20.7 s for three), and a train
# step runs ~14,000; with three calls per profile over ~30 profiles the
# whole script took 997 and 1,170 s on two H100 machines whose timed
# steps differed by 3 %
PROFILE_CALLS = 1
# the whole script (main) times its train steps without profiling them and
# times each loader over its first LOADER_BATCHES batches: a profiled step
# takes seconds of host time to tabulate (~20 of them in a whole run), and
# the loader sweeps ~50 s over full epochs; each path run alone
# (``--zoo``, ``--data-path``, ...) keeps both
PROFILE_STEPS = True
LOADER_BATCHES = None
# the whole script times at most this many train steps after one warm-up
# (``time_steps``); a path run alone takes each caller's counts
TIMED_STEPS_CAP = None


def profile(label: str, engine, waves, fn=None, top: int = 12,
            host: bool = False) -> None:
    """Device time by kernel over ``PROFILE_CALLS`` forwards
    (torch.profiler), or calls of ``fn``; with ``host``, also the host's:
    aten operators per call and those with the most self time, and the
    convolution gradients with the most device time, by input shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof
    fn = fn or (lambda: engine.embed_fn(waves))
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
              record_shapes=host) as p:
        t0 = time.time()
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / PROFILE_CALLS * 1e3
    # device-side events only (kernels, copies): an aten op's self device
    # time repeats the time of the kernels it launched
    events = [e for e in p.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(events, key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / PROFILE_CALLS / 1e3
    log(f"[{label} profile] wall {wall:.2f} ms per call, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f} %)")
    share = busy / wall
    for e in rows[:top]:
        if dev_us(e) <= 0:
            break
        per_call = dev_us(e) / PROFILE_CALLS / 1e3
        log(f"[{label} profile] {per_call:8.3f} ms/call "
            f"{100 * per_call / wall:5.1f} %  "
            f"{e.count // PROFILE_CALLS:4d}x  {e.key[:90]}")
    if host:
        ops = [e for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("aten::")]
        calls = sum(e.count for e in ops) / PROFILE_CALLS
        log(f"[{label} profile] host: {calls:.0f} aten operator calls per "
            f"call ({wall / max(calls, 1) * 1e3:.1f} us of wall each)")
        for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:6]:
            log(f"[{label} profile] host "
                f"{e.self_cpu_time_total / PROFILE_CALLS / 1e3:8.3f} "
                f"ms/call self {e.count // PROFILE_CALLS:5d}x  {e.key}")

        def total_dev_us(e):
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
        convs = [e for e in p.key_averages(group_by_input_shape=True)
                 if e.key == "aten::convolution_backward"]
        for e in sorted(convs, key=total_dev_us, reverse=True)[:4]:
            log(f"[{label} profile] conv backward "
                f"{total_dev_us(e) / PROFILE_CALLS / 1e3:8.3f} ms/call "
                f"{e.count // PROFILE_CALLS:3d}x "
                f"grad, input, weight {e.input_shapes[:3]}")
    # the port's kernels by their function names in csrc/
    for name, tag in (("K1", "mel_kernel"), ("K2", "cascade_kernel"),
                      ("K3", "qmm_")):
        mine = [e for e in events if tag in e.key]
        if mine:
            ms = sum(dev_us(e) for e in mine) / PROFILE_CALLS / 1e3
            log(f"[{label} profile] {name}: {ms:.3f} ms/call "
                f"({100 * ms / wall:.1f} %) over "
                f"{sum(e.count for e in mine) // PROFILE_CALLS} launches "
                "per forward")
    return share


# ----------------------------------------------------------------------
# path E: training the default stack
# ----------------------------------------------------------------------
# parameters whose gradient is zero by construction (a softmax over time
# ignores a per-channel shift; the instance norm's scale and offset are
# undone by the log-magnitude's mean over time and the band-pass sinc):
# both devices move them on rounding noise alone, so update cosines leave
# them out
# paths E and F run here; tests/test_torch_port_train_smoke.py sets "cpu"
E_DEVICE = "cuda"
ZERO_GRAD = ("AttentiveStatisticsPooling_0.Conv1d_0.Conv_0.bias",
             "raw_branch.Conv_2.bias", "raw_branch.BatchNorm_0.bias",
             "raw_branch.inorm_scale", "raw_branch.inorm_bias")


def train_state(h, device, seed: int = 7, augment_fn=None):
    """The default stack with its head and optimizer on ``device``, its
    weights drawn from ``seed`` as flax draws them; ``augment_fn`` goes to
    the train step."""
    from speakerverification_tpu_torch.builder import (
        encoder_from_hparams,
        optimizer_from_hparams,
    )
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    from speakerverification_tpu_torch.builder import (
        compute_dtype_from_hparams,
    )
    model = encoder_from_hparams(h, with_loss=True).to(device)
    tx = optimizer_from_hparams(h)
    state = create_train_state(model, tx, seed)
    step = make_train_step(model, tx,
                           compute_dtype=compute_dtype_from_hparams(h),
                           accum_steps=int(h.get("accumulate_steps", 1)),
                           augment_fn=augment_fn)
    return state, step


def _to(tree, device):
    """An optimizer state's tensors copied to ``device``."""
    import torch
    from speakerverification_tpu_torch.optim import ParamTree
    if isinstance(tree, ParamTree):
        return ParamTree({k: v.detach().to(device, copy=True)
                          for k, v in tree.items()})
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return tree


def copy_state(src, dst) -> None:
    """``dst`` (on its own device) set to ``src``: weights, statistics,
    optimizer state and step."""
    import torch
    device = next(dst.model.parameters()).device
    with torch.no_grad():
        dst.model.load_state_dict(src.model.state_dict())
    dst.opt_state = _to(src.opt_state, device)
    dst.step = src.step


def seeded_batch(seed: int, n_spk: int, n_per: int, h: dict):
    """``[n_spk, n_per, T]`` waves of the config's crop length and
    ``n_spk`` distinct labels."""
    import numpy as np
    spec, n_classes = h["audio_spec"], h["nClasses"]
    samples = int(spec["sentence_len"] * spec["sample_rate"])
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.normal(0, 1, (n_spk, n_per, samples))).astype(
        np.float32)
    label = rng.permutation(n_classes)[:n_spk].astype(np.int64)
    return wave, label


def update_cosine(after, before, ref_after,
                  zero_grad=ZERO_GRAD) -> tuple[float, float, str]:
    """Cosine between two updates over all parameters but ``zero_grad``,
    and the lowest per-tensor cosine with its name."""
    import torch
    keep = [k for k in before if not k.endswith(zero_grad)]
    a = torch.cat([(after[k].detach().cpu() - before[k]).double().ravel()
                   for k in keep])
    b = torch.cat([(ref_after[k].detach().cpu() - before[k]).double().ravel()
                   for k in keep])
    worst, name = 2.0, ""
    for k in keep:
        x = (after[k].detach().cpu() - before[k]).double().ravel()
        y = (ref_after[k].detach().cpu() - before[k]).double().ravel()
        c = float(x @ y / max(float(x.norm() * y.norm()), 1e-300))
        if c < worst:
            worst, name = c, k
    return float(a @ b / (a.norm() * b.norm())), worst, name


def loss_grads(state, wave, label) -> dict:
    """The gradient of the training loss at ``state`` (the BatchNorm
    statistics the forward updates are put back)."""
    import torch
    saved = [s.clone() for s in state.batch_stats.values()]
    state.model.train()
    loss, _ = state.model(wave, label)
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                allow_unused=True)
    with torch.no_grad():
        for s, s0 in zip(state.batch_stats.values(), saved):
            s.copy_(s0)
    return {k: torch.zeros_like(state.params[k]) if g is None else g
            for k, g in zip(names, grads)}


def branch_cosines(got: dict, want: dict, zero_grad=ZERO_GRAD) -> dict:
    """Cosine of two gradient trees over each branch's parameters (all
    but ``zero_grad``): the ECAPA half (fed by K1), the raw branch, the
    loss head."""
    out = {}
    for branch in ("backbone.ecapa.", "backbone.raw_branch.", "loss."):
        keys = [k for k in want if k.startswith(branch)]
        if not keys:        # a one-branch model (the CPU rehearsal's)
            keys = [k for k in want if not k.startswith("loss.")]
            branch = "backbone.ecapa."
        zeros = {k: 0 * want[k].detach().cpu() for k in keys}
        cos, worst, name = update_cosine({k: got[k] for k in keys}, zeros,
                                         {k: want[k] for k in keys},
                                         zero_grad)
        out[branch.rstrip(".")] = {"cos": cos, "lowest": worst,
                                   "lowest_at": name}
    return out


def gradient_check(h, tag: str, bars: dict, zero_grad=ZERO_GRAD):
    """The gradient of the training loss (4 speakers x 2 crops) at one
    state, the CPU's copied to the card, on the card and on the CPU's
    plain path: each branch's cosine must reach its bar in ``bars``.
    Returns both states with their steps, and the card's launches."""
    import torch
    cpu, cpu_step = train_state(h, "cpu")
    card, card_step = train_state(h, E_DEVICE)
    copy_state(cpu, card)
    wave, label = seeded_batch(10, 4, 2, h)
    reset_counts()
    g_card = loss_grads(card, torch.from_numpy(wave).to(E_DEVICE),
                        torch.from_numpy(label).to(E_DEVICE))
    counts = read_counts()
    g_cpu = loss_grads(cpu, torch.from_numpy(wave), torch.from_numpy(label))
    grad = branch_cosines(g_card, g_cpu, zero_grad)
    ok = all(v["cos"] >= bars[k] for k, v in grad.items())
    log(f"[{tag} gradient] card vs CPU at the initial state, by branch "
        f"(bars: {json.dumps(bars)}): " + json.dumps(grad)
        + (" ok" if ok else " FAIL"))
    if not ok:
        fail(f"path {tag}: the card's gradient disagrees with the CPU's")
    return (cpu, cpu_step), (card, card_step), counts


def path_e1(h) -> dict:
    """Three fp32 train steps of the default stack (4 speakers x 2 crops of
    2 s) on the card and on the CPU's plain path, each from the same state
    (the CPU's, copied to the card before the step); first the gradient
    of the loss at the initial state on both.

    The ECAPA half (K1's consumer) is well conditioned; the raw branch's
    train-mode BatchNorms over log-sinc features turn rounding (cuDNN's
    sums against the CPU's) into percent-level gradient differences, in
    its sinc parameters most: its gradient's bar is 0.95. The steps'
    bars are those the CPU tests hold the port and the JAX package to
    (tests/test_torch_port_train_raw3.py): AdaBelief's first update is
    close to the sign of the gradient."""
    import torch
    lr = h["lr"]
    (cpu, cpu_step), (card, card_step), counts = gradient_check(
        h, "E1", {"backbone.ecapa": 0.999, "backbone.raw_branch": 0.95,
                  "loss": 0.999})
    rows = []
    for i in range(3):
        wave, label = seeded_batch(10 + i, 4, 2, h)
        copy_state(cpu, card)
        before = {k: p.detach().clone() for k, p in cpu.params.items()}
        reset_counts()
        card, mc = card_step(card, torch.from_numpy(wave).to(E_DEVICE),
                             torch.from_numpy(label).to(E_DEVICE), lr)
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            counts[k] += v
        cpu, mp = cpu_step(cpu, torch.from_numpy(wave),
                           torch.from_numpy(label), lr)
        lc, lp = float(mc["loss"]), float(mp["loss"])
        stats = max(float((card.batch_stats[k].cpu() - s).abs().max()
                          / s.abs().max()) for k, s in cpu.batch_stats.items())
        cos, worst, name = update_cosine(card.params, before, cpu.params)
        row = {"loss_card": lc, "loss_cpu": lp,
               "loss_rel": abs(lc - lp) / abs(lp),
               "prec1_card": float(mc["prec1"]),
               "prec1_cpu": float(mp["prec1"]), "stats_rel": stats,
               "update_cos": cos, "worst_tensor_cos": worst,
               "worst_tensor": name}
        log(f"[E1 step {i}] " + json.dumps(row))
        rows.append(row)
    ok = (all(r["loss_rel"] <= 2e-3 and r["stats_rel"] <= 2e-2
                  and r["update_cos"] >= 0.9
                  and abs(r["prec1_card"] - r["prec1_cpu"]) <= 100 / 8 + 1e-6
                  for r in rows)
          and counts["mel_frontend"] == 4 and counts["res2net_cascade"] == 0
          and counts["quant_matmul"] == 0)
    log(f"[E1] card vs CPU over 3 steps: max loss rel "
        f"{max(r['loss_rel'] for r in rows):.3e} (bar 2e-3), max stats rel "
        f"{max(r['stats_rel'] for r in rows):.3e} (bar 2e-2), min update "
        f"cos {min(r['update_cos'] for r in rows):.6f} (bar 0.9); "
        f"launches on the card (1 gradient + 3 steps) {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path E1: the card's train steps disagree with the CPU's")
    return counts


def busy_pct(busy) -> str:
    """A profiled step's device busy share, or that none was taken."""
    return "not profiled" if busy is None else f"{100 * busy:.1f} %"


def time_steps(label: str, h, card: str, steps: int = 6,
               warmup: int = 2, tag: str = "E2", built=None,
               step_args=(), batch=None) -> dict:
    """ms per train step at the yaml's batch (``batch_size`` speakers x 2
    crops) by CUDA events over ``steps`` steps after ``warmup``, peak
    memory, and (``PROFILE_STEPS``) a profile of the step, whose device
    busy share it returns. ``built`` is a
    ``(state, step)`` to time instead of a fresh one; ``step_args``
    follow the learning rate (a generator and banks); ``batch`` is a
    loader's ``(wave, label)`` to step on instead of a seeded one."""
    import torch
    if TIMED_STEPS_CAP is not None:
        steps, warmup = min(steps, TIMED_STEPS_CAP), min(warmup, 1)
    state, step = built or train_state(h, E_DEVICE)
    n_spk = int(h["dataloader_options"]["batch_size"])
    n_crops = 2 * n_spk
    wave, label_np = batch or seeded_batch(20, n_spk, 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    lab = torch.from_numpy(label_np).to(E_DEVICE)
    box = {"state": state}

    def one():
        box["state"], m = step(box["state"], wave, lab, h["lr"], *step_args)
        return m
    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    for _ in range(steps):
        m = one()
    end.record()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / steps * 1e3
    ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(m["loss"])
    if not (loss == loss and abs(loss) < 1e4):
        fail(f"path {tag} {label}: loss not finite ({loss})")
    log(f"[{tag} {label}] {ms:.2f} ms per step (CUDA events over {steps} "
        f"steps; host wall {wall:.2f} ms) -> {n_crops / ms * 1e3:.1f} "
        f"crops/s, peak memory {peak:.2f} GiB, loss {loss:.4f} ({card})")
    busy = (profile(f"{tag} {label}", None, None, fn=one, host=True)
            if PROFILE_STEPS else None)
    return {"ms": ms, "crops_per_s": n_crops / ms * 1e3, "peak_gib": peak,
            "wall_ms": wall, "busy": busy, "steps": warmup + steps}


def check_accum(h) -> None:
    """accumulate_steps 2: the step's loss is the mean of the two
    microbatches' losses, each from the step's incoming statistics."""
    import torch
    h2 = {**h, "accumulate_steps": 2}
    state, step = train_state(h2, E_DEVICE)
    wave, label = seeded_batch(21, 32, 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    label = torch.from_numpy(label).to(E_DEVICE)
    stats = [s.clone() for s in state.batch_stats.values()]
    halves = []
    state.model.train()
    with torch.no_grad():
        for i in range(2):
            for s, s0 in zip(state.batch_stats.values(), stats):
                s.copy_(s0)
            loss, _ = state.model(wave[16 * i:16 * (i + 1)],
                                  label[16 * i:16 * (i + 1)])
            halves.append(float(loss))
        for s, s0 in zip(state.batch_stats.values(), stats):
            s.copy_(s0)
    state, m = step(state, wave, label, h["lr"])
    want = (halves[0] + halves[1]) / 2
    rel = abs(float(m["loss"]) - want) / abs(want)
    log(f"[E2 accum 2] step loss {float(m['loss']):.6f}, mean of the "
        f"microbatch losses {want:.6f}: rel {rel:.3e} (bar 1e-5) "
        f"{'ok' if rel <= 1e-5 else 'FAIL'}")
    if rel > 1e-5:
        fail("path E2: the accumulated step's loss is not the microbatch "
             "mean")


def check_learning(label: str, h, steps: int = 20, tag: str = "E3",
                   built=None, step_args=(), batch=None) -> None:
    """``steps`` steps on one fixed batch of the yaml's size (a seeded
    one, or a loader's ``(wave, label)``), the yaml's cosine schedule over
    them: the last 5 losses' mean falls below the first 5's (means, since
    SpecAugment draws new masks at every step and makes each loss a
    sample)."""
    import torch
    from speakerverification_tpu_torch.builder import scheduler_from_hparams
    state, step = built or train_state(h, E_DEVICE)
    sched, _ = scheduler_from_hparams(h, steps)
    wave, lab = batch or seeded_batch(
        22, int(h["dataloader_options"]["batch_size"]), 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    lab = torch.from_numpy(lab).to(E_DEVICE)
    losses = []
    for i in range(steps):
        state, m = step(state, wave, lab, sched(i), *step_args)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    ok = all(x == x for x in losses) and last < first
    log(f"[{tag} {label}] {steps} steps on one batch: first loss "
        f"{losses[0]:.4f}, mean of the first 5 {first:.4f}, of the last 5 "
        f"{last:.4f}, prec1 "
        f"{float(m['prec1']):.1f} % {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"path {tag} {label}: the loss did not fall ({losses})")


def write_train_corpus(root, sr: int, n_spk: int = 64, n_utt: int = 4,
                       seconds: float = 3.0):
    """``n_spk`` speakers x ``n_utt`` WAVs (a tone per speaker over
    noise), the manifest ``train.csv`` over all of them, and a trial list
    of each speaker's first two files against the next speaker's."""
    import numpy as np
    from speakerverification_tpu_torch.data.audio import write_wav
    from speakerverification_tpu_torch.data.manifest import Manifest
    rng = np.random.default_rng(30)
    tt = np.arange(int(seconds * sr)) / sr
    rows, files = [], {}
    for s in range(n_spk):
        for u in range(n_utt):
            sig = (0.2 * np.sin(2 * np.pi * (110.0 + 9.0 * s) * tt
                                + rng.uniform(0, 6))
                   + 0.05 * rng.normal(0, 1, tt.size))
            path = root / "data" / f"spk{s:03d}" / f"u{u}.wav"
            write_wav(path, sig.astype(np.float32), sr)
            rows.append([f"spk{s:03d}", str(path), seconds, "wav"])
            files.setdefault(s, []).append(str(path))
    Manifest.write(root / "meta" / "train.csv", rows)
    trials = root / "trials.txt"
    trials.write_text("".join(
        f"1 {files[s][0]} {files[s][1]}\n0 {files[s][0]} "
        f"{files[(s + 1) % n_spk][2]}\n" for s in range(n_spk)))
    return trials, 2 * n_spk


def path_e4(tmp, card: str, h: dict, tag: str = "E4",
            train_args=(), prepare=None, epochs: int = 2,
            n_spk: int = 64) -> dict:
    """``--do_train`` through the CLI on the yaml's training keys (paths and
    number_of_epochs: ``epochs`` changed) over a synthetic manifest, then
    ``--do_infer --eval`` of the trained checkpoint, in this process so
    that the kernels' launches are counted. ``prepare(config_path)`` runs
    between writing the config and training; the corpus has ``n_spk``
    speakers."""
    import io
    import re
    from speakerverification_tpu_torch.cli.main import main as cli_main
    sr = h["audio_spec"]["sample_rate"]
    t0 = time.time()
    trials, n_trials = write_train_corpus(tmp, sr, n_spk=n_spk)
    log(f"[{tag}] {n_trials // 2} speakers' WAVs written in "
        f"{time.time() - t0:.1f} s")
    cfg = {**h, "number_of_epochs": epochs,
           "save_folder": str(tmp / "save"), "data_folder": str(tmp / "data"),
           "train_annotation": str(tmp / "meta" / "train.csv"),
           "evaluation_file": str(trials),
           "pretrained": {"use": False}}
    path = tmp / f"{h['model']['name']}_train.yaml"
    # YAML's JSON subset: read with or without PyYAML
    path.write_text(json.dumps(cfg, indent=1))
    if prepare is not None:
        prepare(path)
    dev_args = [] if E_DEVICE == "cuda" else ["--device", E_DEVICE]
    out = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--do_train", "--config", str(path), *train_args,
                       *dev_args])
    train_s = time.time() - t0
    import torch
    torch.cuda.synchronize()
    train_counts = read_counts()
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[{tag} train] {line}")
    run = tmp / "save" / h["model"]["name"] / h["criterion"]["name"]
    epoch_s = [float(x) for x in re.findall(r"utt/s, ([0-9.]+) s\)", text)]
    missing = [n for n in ("model/best_state.msgpack",
                           "model/last_state.msgpack", "result/scores.txt")
               if not (run / n).exists()]
    scores = ((run / "result" / "scores.txt").read_text().splitlines()
              if not missing else [])
    if rc != 0 or missing or len(scores) != len(epoch_s) \
            or len(epoch_s) != epochs:
        fail(f"path {tag}: --do_train rc {rc}, missing {missing}, scores "
             f"{scores}, epochs {epoch_s}")
    steps = int(json.loads((run / "model" / "model_state_log.json")
                           .read_text())["step"])
    opts = h["dataloader_options"]
    log(f"[{tag}] --do_train: {epochs} epochs, {steps} steps of "
        f"{opts['batch_size'] * opts['nPerSpeaker']} crops, "
        f"{train_s:.1f} s in all, per epoch {epoch_s} s ({card}); "
        f"launches {train_counts}")
    if train_counts["mel_frontend"] != steps:
        fail(f"path {tag}: {steps} train steps but K1 launched "
             f"{train_counts['mel_frontend']} times")
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--do_infer", "--eval", "--config", str(path),
                       *dev_args])
    torch.cuda.synchronize()
    eval_counts = read_counts()
    for line in out.getvalue().splitlines():
        log(f"[{tag} eval] {line}")
    rows = (run / "result" / "evaluation_results.csv").read_text() \
        .strip().splitlines()
    if rc != 0 or "loaded weights" not in out.getvalue() or \
            len(rows) != n_trials + 1 or eval_counts["mel_frontend"] < 1:
        fail(f"path {tag}: --do_infer --eval rc {rc}, {len(rows) - 1} trials "
             f"scored, launches {eval_counts}")
    log(f"[{tag}] --do_infer --eval of best_state: {n_trials} trials, "
        f"launches {eval_counts}")
    return {"counts": {k: train_counts[k] + eval_counts[k]
                       for k in KERNELS}, "epochs_s": epoch_s, "steps": steps}


def path_e(tmp, card: str, h: dict = RAW3_TRAIN_HPARAMS) -> dict:
    """Training the default stack at full width (E1-E4)."""
    h = dict(h)
    e1 = path_e1(h)
    reset_counts()
    fp32 = time_steps("fp32", h, card)
    bf16 = time_steps("bf16 mixedprec", {**h, "mixedprec": True}, card)
    check_accum(h)
    acc = time_steps("fp32 accum 2", {**h, "accumulate_steps": 2}, card,
                     steps=5)
    check_learning("fp32", h)
    check_learning("bf16", {**h, "mixedprec": True})
    e23 = read_counts()
    e4 = path_e4(tmp, card, h)
    counts = {k: e1[k] + e23[k] + e4["counts"][k] for k in KERNELS}
    log(f"[E] launches over E1-E4: {counts}")
    return {"counts": counts, "fp32": fp32, "bf16": bf16, "accum2": acc,
            "epochs_s": e4["epochs_s"]}


# ----------------------------------------------------------------------
# path F: the RawNet2 family, served and trained
# ----------------------------------------------------------------------
# parameters of path F's stack whose gradient is zero by construction (a
# softmax ignores a shift of all its inputs: the attention convs' biases,
# the BatchNorm bias before the raw branch's attention conv, AngularProto's
# logit bias): update cosines leave them out
F_ZERO_GRAD = ("AttentiveStatisticsPooling_0.Conv1d_0.Conv_0.bias",
               "raw_branch.Conv_2.bias", "raw_branch.BatchNorm_1.bias",
               "AngularProto_0.b")
# the raw branch's gradient bar: its strided-conv front has no log-sinc,
# so unlike path E's RawNet3 it is well conditioned in training mode (the
# CPU tests put both packages' fp32 steps within 5e-6 of float64)
F_GRAD_BARS = {"backbone.ecapa": 0.999, "backbone.raw_branch": 0.999,
               "loss": 0.999}


def path_f3(card: str) -> dict:
    """One forward of each other builder of the family at its yaml's
    width (16 crops), card against the CPU's plain path; K1 once per
    forward of a hybrid, never for a standalone raw model."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    counts = dict.fromkeys(KERNELS, 0)
    for i, (yaml_name, h) in enumerate(F3_VARIANTS):
        name = h["model"]["name"]
        engine = InferenceEngine(h, device=E_DEVICE)
        randomize_bn_(engine.model, seed=10 + i)
        spec = h["audio_spec"]
        samples = int(spec["sentence_len"] * spec["sample_rate"])
        waves = (0.1 * np.random.default_rng(20 + i).normal(
            0, 1, (16, samples))).astype(np.float32)
        reset_counts()
        engine.embed_fn(waves)
        torch.cuda.synchronize()
        got = read_counts()
        compare_with_cpu(engine, waves, f"F3 {name}")
        hybrid = hasattr(engine.model.backbone, "frontend")
        want = {"mel_frontend": int(hybrid), "res2net_cascade": 0,
                "quant_matmul": 0}
        ms = cuda_ms(lambda: engine.embed_fn(waves), iters=5, warmup=1)
        n_params = sum(p.numel() for p in engine.model.parameters())
        log(f"[F3 {name}] {yaml_name} keys, {spec['sample_rate']} Hz, "
            f"{samples} samples, {n_params / 1e6:.2f} M params: 16 crops "
            f"{ms:.2f} ms per forward ({card}); launches {got} "
            f"{'ok' if got == want else 'FAIL'}")
        if got != want:
            fail(f"path F3 {name}: launches {got}, expected {want}")
        for k in KERNELS:
            counts[k] += got[k]
        del engine
    return counts


def path_f(tmp, card: str, h: dict = RAW_ECAPA_HPARAMS) -> dict:
    """The RawNet2 family at full width (F1-F4): Raw_ECAPA_conv_asp served
    over HTTP and timed at the serving batch (F1); its train step with
    AAmSoftmaxAP over 17,982 classes and AdaBelief, the gradient against
    the CPU's, timed in fp32 and bf16, learning on one batch (F2); every
    other builder of the family against the CPU (F3); ``--do_train`` then
    ``--do_infer --eval`` through the CLI (F4)."""
    import numpy as np
    h = dict(h)
    f1 = serve_over_http("F1", h, bn_seed=5, device=E_DEVICE)
    engine = f1["engine"]
    waves = (0.1 * np.random.default_rng(6).normal(
        0, 1, (f1["n_crops"], f1["samples"]))).astype(np.float32)
    throughput("F1 Raw_ECAPA_conv_asp", engine, waves, h["num_eval"], card)
    profile("F1", engine, waves)
    del engine, f1["engine"]
    _, _, grad_counts = gradient_check(h, "F2", F_GRAD_BARS, F_ZERO_GRAD)
    reset_counts()
    fp32 = time_steps("fp32", h, card, tag="F2")
    bf16 = time_steps("bf16 mixedprec", {**h, "mixedprec": True}, card,
                      tag="F2")
    check_learning("fp32", h, tag="F2")
    check_learning("bf16", {**h, "mixedprec": True}, tag="F2")
    f2 = read_counts()
    f3 = path_f3(card)
    f4 = path_e4(tmp, card, h, tag="F4")
    counts = {k: f1["counts"][k] + grad_counts[k] + f2[k] + f3[k]
              + f4["counts"][k] for k in KERNELS}
    log(f"[F] launches over F1-F4: {counts}")
    if counts["res2net_cascade"] or counts["quant_matmul"]:
        fail(f"path F ran the cascade or int8 kernel: {counts}")
    return {"counts": counts, "fp32": fp32, "bf16": bf16,
            "epochs_s": f4["epochs_s"]}


# ----------------------------------------------------------------------
# path G: training with augmentation
# ----------------------------------------------------------------------
# the augment_options of yaml/raw3_ecapa.yaml and yaml/ecapa_tdnn.yaml
# without their folders, which path G points at a synthetic corpus, and
# ecapa_tdnn.yaml's training keys (tests/test_torch_port_augment_train.py
# holds them against the files)
RAW3_AUGMENT = {
    "augment_chain": ["env_corrupt", "time_domain"],
    "noise_sets": ["noise", "speech", "music", "noise_vad", "noise_rirs"],
    "noise_proportion": [0.2, 0.1, 0.2, 0.25, 0.25],
    "noise_snr": {"noise": [0, 5], "speech": [3, 20], "music": [5, 15],
                  "noise_vad": [3, 15], "noise_rirs": [3, 15]},
    "noise_samples": {"noise": [1, 1], "speech": [3, 7], "music": [1, 1],
                      "noise_vad": [1, 1], "noise_rirs": [1, 1]},
    "augment_time_domain": {"volume": 4, "speed": [0.95, 1.05],
                            "pitch": [-0.5, 0.5],
                            "proportion": [0.25, 0.25, 0.25],
                            "combined": False},
}
ECAPA_AUGMENT = {
    **RAW3_AUGMENT, "augment_chain": ["env_corrupt", "spec_domain"],
    "noise_snr": {"noise": [0, 15], "speech": [13, 20], "music": [5, 15],
                  "noise_vad": [3, 15], "noise_rirs": [3, 15]},
}
ECAPA_TRAIN_HPARAMS = {
    **ECAPA_TDNN_HPARAMS,
    "number_of_epochs": 100, "batch_size": 128, "lr": 0.001,
    "base_lr": 1e-8, "max_lr": 0.001, "step_size": 10, "shuffle": True,
    "random_chunk": True, "nClasses": 5994,
    "dataloader_options": {"batch_size": 128, "shuffle": True,
                           "num_workers": 8, "max_seg_per_spk": 500,
                           "nPerSpeaker": 2, "split_ratio": -1},
    "criterion": {"name": "AAmSoftmax", "margin": 0.2, "scale": 30},
    "optimizer": {"name": "AdaBelief", "weight_decay": 0.00002,
                  "lr_decay": 0.95},
    "callbacks": {"name": "cosine_annealinglr_pt", "base_lr": 1e-8,
                  "max_lr": 0.001},
    "early_stopping": False, "es_patience": 15, "augment": False,
}


def write_noise_corpus(root, sr: int, n_files: int = 8,
                       seconds: float = 5.0, rir_seconds: float = 1.0,
                       seed: int = 40) -> dict:
    """Noise folders in the layout ``AugmentWav`` globs, at ``sr``: MUSAN's
    noise (coloured noise), speech (tone sweeps over noise) and music
    (chords), split into ``seconds``-long files as the recipes split
    MUSAN; ``noise_vad`` and RIRS_NOISES' point-source noises; simulated
    RIRs of ``rir_seconds`` (a direct peak, then a decaying tail). Returns
    ``augment_paths``."""
    import numpy as np
    from speakerverification_tpu_torch.data.audio import write_wav
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    musan = root / "musan_split"
    for i in range(n_files):
        white = rng.normal(0, 1, n)
        brown = np.cumsum(white)
        brown = brown - np.convolve(brown, np.ones(400) / 400, "same")
        sigs = {
            "noise": 0.3 * brown / np.abs(brown).max(),
            "speech": 0.3 * np.sin(2 * np.pi * (150 + 100 * np.sin(
                2 * np.pi * 0.7 * tt + i)) * tt) * (0.5 + 0.5 * np.sin(
                    2 * np.pi * 3 * tt)) + 0.02 * white,
            "music": sum(0.1 * np.sin(2 * np.pi * f * (i + 1) * tt)
                         for f in (110, 138.6, 164.8)),
        }
        for cat, sig in sigs.items():
            write_wav(musan / cat / f"src{i % 3}" / f"clip{i}" / f"{i}.wav",
                      sig.astype(np.float32), sr)
        write_wav(root / "noise_vad" / f"v{i % 2}" / f"{i}.wav",
                  (0.2 * white).astype(np.float32), sr)
        write_wav(root / "RIRS_NOISES" / "pointsource_noises" / f"n{i}.wav",
                  (0.25 * rng.uniform(-1, 1, n)).astype(np.float32), sr)
        m = int(rir_seconds * sr)
        rir = rng.normal(0, 1, m) * np.exp(-np.arange(m) / (0.05 * (i + 1)
                                                              * sr))
        rir[int(rng.integers(5, 60))] = 3.0
        write_wav(root / "RIRS_NOISES" / "simulated_rirs" / f"room{i % 2}"
                  / f"Room{i:03d}" / "r.wav",
                  (0.9 * rir / np.abs(rir).max()).astype(np.float32), sr)
    return noise_paths(root)


def noise_paths(root) -> dict:
    """``augment_paths`` of a corpus that :func:`write_noise_corpus` wrote
    under ``root``."""
    return {"musan": str(root / "musan_split"),
            "noise_vad": str(root / "noise_vad"),
            "rirs": str(root / "RIRS_NOISES")}


def g_corpora(tmp) -> dict:
    """Path G's synthetic corpora under ``tmp``, written unless they are
    there: noise at 8 and 16 kHz (``noise8k``, ``noise16k``), 128 x 16
    speakers' 3 s WAVs at 8 kHz with their manifest (``g1``), 256 x 3 at
    16 kHz (``g3``). Returns the noise corpora's ``augment_paths``."""
    sr8 = RAW3_TRAIN_HPARAMS["audio_spec"]["sample_rate"]
    sr16 = ECAPA_TDNN_HPARAMS["audio_spec"]["sample_rate"]
    if not (tmp / "g3" / "meta" / "train.csv").exists():
        t0 = time.time()
        write_noise_corpus(tmp / "noise8k", sr8)
        write_train_corpus(tmp / "g1", sr8, n_spk=128, n_utt=16)
        write_noise_corpus(tmp / "noise16k", sr16)
        write_train_corpus(tmp / "g3", sr16, n_spk=256, n_utt=3)
        log(f"[G] synthetic noise corpora (8 and 16 kHz) and 128 x 16 (8 "
            f"kHz) and 256 x 3 (16 kHz) speaker WAVs written in "
            f"{time.time() - t0:.1f} s")
    return {"noise8": noise_paths(tmp / "noise8k"),
            "noise16": noise_paths(tmp / "noise16k")}


def augmented(h: dict, options: dict, paths: dict, **extra) -> dict:
    return {**h, "augment": True,
            "augment_options": {**options, "augment_paths": paths}, **extra}


def loader_epoch(h: dict, label: str, card: str, workers: int,
                 tag: str = "G1") -> dict:
    """ms per batch of the training loader with ``workers`` decode
    threads over one full epoch (its first ``LOADER_BATCHES`` when set),
    the first batch (thread start) apart, and the process's CPU seconds
    over the same wall seconds: the number of cores the loader kept busy
    on average."""
    import itertools
    from speakerverification_tpu_torch.data.loader import train_data_loader
    opts = {**h["dataloader_options"], "num_workers": workers}
    loader = train_data_loader({**h, "dataloader_options": opts})
    t0 = time.time()
    it = iter(loader)
    next(it)
    t1, c1 = time.time(), time.process_time()
    n = sum(1 for _ in itertools.islice(it, LOADER_BATCHES))
    wall, cpu = time.time() - t1, time.process_time() - c1
    ms = wall / max(n, 1) * 1e3
    log(f"[{tag} loader {label}] {ms:.1f} ms per batch of "
        f"{opts['batch_size'] * opts['nPerSpeaker']} crops over "
        f"{'the epoch' + chr(39) + 's' if LOADER_BATCHES is None else 'the'} "
        f"{n} batches after the first ({1e3 * (t1 - t0):.1f} ms), "
        f"{loader.num_workers} decode threads, {cpu / wall:.2f} cores busy, "
        f"engine {'on' if loader.augmentor else 'off'} ({card})")
    return {"ms": ms, "cores": cpu / wall, "batches": n}


def host_breakdown(h: dict, card: str, n: int = 64) -> dict:
    """CPU ms per crop of each stage of the loader's augmented crop, on
    one thread over ``n`` crops: decode, time_domain, the re-crop,
    env_corrupt."""
    import numpy as np
    from speakerverification_tpu_torch.data.audio import load_wav
    from speakerverification_tpu_torch.data.augment import (
        random_time_domain_augment,
    )
    from speakerverification_tpu_torch.data.loader import train_data_loader
    loader = train_data_loader(h)
    setting = h["augment_options"]["augment_time_domain"]
    rng = np.random.default_rng(0)
    ms = dict.fromkeys(("decode", "time_domain", "recrop", "env_corrupt"),
                       0.0)
    for i in range(n):
        t0 = time.perf_counter()
        audio = load_wav(loader.manifest.paths[i], loader.spec,
                         evalmode=False, rng=rng)
        t1 = time.perf_counter()
        audio = random_time_domain_augment(audio, setting, rng=rng)
        t2 = time.perf_counter()
        audio = load_wav(audio[0], loader.spec, evalmode=False, rng=rng,
                         normalize=False)
        t3 = time.perf_counter()
        loader.augmentor.env_corrupt(audio, rng)
        t4 = time.perf_counter()
        for k, dt in zip(ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            ms[k] += dt * 1e3 / n
    log(f"[G1 host breakdown] CPU ms per crop on one thread over {n} "
        f"crops: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; {64 * sum(ms.values()):.1f} ms per 64 crops ({card})")
    return ms


def train_from_loader(h: dict, label: str, card: str, steps: int = 8,
                      loader=None, built=None, step_args=(),
                      tag: str = "G1"):
    """The train step fed by the loader, as ``Trainer.train_epoch`` feeds
    it: wall per step over ``steps`` steps after 2, all synchronized.
    ``loader`` and ``built`` (state, step) replace the yaml's own;
    ``step_args`` follow the learning rate."""
    import torch
    from speakerverification_tpu_torch.data.loader import train_data_loader
    state, step = built or train_state(h, E_DEVICE)
    loader = loader or train_data_loader(h)
    walls = []
    epoch = 1
    while len(walls) < steps + 2:
        loader.set_epoch(epoch)
        t0 = time.time()
        for batch in loader:
            wave = torch.from_numpy(batch["wave"]).to(E_DEVICE)
            label_ = torch.from_numpy(batch["label"]).to(E_DEVICE)
            state, m = step(state, wave, label_, h["lr"], *step_args)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            t0 = time.time()
            if len(walls) == steps + 2:
                break
        epoch += 1
    wall = sum(walls[2:]) / steps * 1e3
    log(f"[{tag} loop {label}] loader + step: {wall:.1f} ms per step over "
        f"{steps} steps, loss {float(m['loss']):.4f} ({card})")
    return wall


def check_card_vs_cpu(banks, sr: int) -> dict:
    """Each device apply with the same drawn numbers on the card and on
    the CPU (64 crops of the yaml's length): the largest absolute
    difference, to 1e-5 of the output's largest magnitude."""
    import torch
    from speakerverification_tpu_torch.ops import device_augment as da
    from speakerverification_tpu_torch.ops import timeaugment as ta
    cpu_banks = da.AugmentBanks(*(b.cpu() for b in banks))
    gen = torch.Generator(E_DEVICE).manual_seed(3)
    x = 0.1 * torch.randn(64, banks.noise.shape[1], device=E_DEVICE,
                          generator=gen)

    def to_cpu(d):
        return type(d)(*(None if f is None else f.cpu() for f in d))
    out = {}
    env = da.draw_env_corrupt(gen, 64, banks)
    pairs = {"env_corrupt": (da.apply_env_corrupt(x, env, banks),
                             da.apply_env_corrupt(x.cpu(), to_cpu(env),
                                                  cpu_banks))}
    for mode in ("np", "torch"):
        d = ta.draw_time_augment(gen, 64, x.shape[1], banks, mode, sr)
        pairs[f"time {mode}"] = (
            ta.apply_time_augment(x, d, banks, sr),
            ta.apply_time_augment(x.cpu(), to_cpu(d), cpu_banks, sr))
    for name, (got, want) in pairs.items():
        err = float((got.cpu() - want).abs().max())
        out[name] = err
        if not err <= 1e-5 * float(want.abs().max()):
            fail(f"path G2: {name} on the card differs from the CPU by {err}")
    return out


def env_shares(banks, n: int = 65536) -> list:
    """The env types of ``n`` rows drawn on the card, against .2/.4/.2/.2
    within 4 sigma."""
    import torch
    from speakerverification_tpu_torch.ops import device_augment as da
    d = da.draw_env_corrupt(torch.Generator(E_DEVICE).manual_seed(4), n,
                            banks)
    share = (torch.bincount(d.augtype, minlength=4).double() / n).cpu()
    p = torch.tensor([0.2, 0.4, 0.2, 0.2], dtype=torch.float64)
    z = ((share - p).abs() / torch.sqrt(p * (1 - p) / n)).tolist()
    if max(z) > 4:
        fail(f"path G2: env types drawn at {share.tolist()} ({z} sigma)")
    return share.tolist()


def time_device_augment(label: str, h: dict, card: str) -> dict:
    """The train step with ``device_augment`` and ``device_time_augment``
    as the Trainer builds it (``training.trainer.device_augmentation``:
    banks from the loader's engine, the augment hook), timed and profiled
    at the yaml's batch."""
    import torch
    from speakerverification_tpu_torch.data.loader import train_data_loader
    from speakerverification_tpu_torch.training.trainer import (
        device_augmentation,
    )
    t0 = time.time()
    loader = train_data_loader(h)
    fn, banks, _ = device_augmentation(h, loader, E_DEVICE)
    build_s = time.time() - t0
    if loader.augmentor is not None or banks is None:
        fail(f"path G2 {label}: env_corrupt did not move to the device")
    gen = torch.Generator(E_DEVICE).manual_seed(1000)
    built = train_state(h, E_DEVICE, augment_fn=fn)
    reset_counts()
    out = time_steps(label, h, card, tag="G2", built=built,
                     step_args=(gen, banks))
    out["loop_ms"] = train_from_loader(h, label, card, loader=loader,
                                       built=built, step_args=(gen, banks),
                                       tag="G2")
    torch.cuda.synchronize()
    out["counts"] = read_counts()
    log(f"[G2 {label}] banks built in {build_s:.1f} s "
        f"({banks.noise.shape[0]} noise crops, {banks.rir.shape[0]} RIRs); "
        f"launches {out['counts']} ({card})")
    out["banks"] = banks
    return out


def path_g(tmp, card: str) -> dict:
    """Training with augmentation at full width (G1-G4)."""
    import torch
    corpora = g_corpora(tmp)
    noise8, noise16 = corpora["noise8"], corpora["noise16"]
    sr8 = RAW3_TRAIN_HPARAMS["audio_spec"]["sample_rate"]
    counts = dict.fromkeys(KERNELS, 0)

    # G1: host env_corrupt + time_domain on the loader's threads
    base = {**RAW3_TRAIN_HPARAMS,
            "train_annotation": str(tmp / "g1" / "meta" / "train.csv")}
    h1 = augmented(base, RAW3_AUGMENT, noise8)
    nw = int(h1["dataloader_options"]["num_workers"])
    sweep = {(aug, w): loader_epoch(hh, aug, card, w)
             for aug, hh in (("augment off", base), ("host augment", h1))
             for w in (1, nw)}
    off, on = sweep["augment off", nw]["ms"], sweep["host augment", nw]["ms"]
    for aug in ("augment off", "host augment"):
        one, many = sweep[aug, 1], sweep[aug, nw]
        log(f"[G1 loader threads] {aug}: {one['ms']:.1f} ms per batch on 1 "
            f"thread ({one['cores']:.2f} cores busy), {many['ms']:.1f} ms on "
            f"{nw} ({many['cores']:.2f} cores busy): x{one['ms'] / many['ms']:.2f} "
            f"({card})")
    host_breakdown(h1, card)
    reset_counts()
    g1 = time_steps("fp32", h1, card, tag="G1")
    loop = train_from_loader(h1, "host augment", card)
    c = read_counts()
    for k in KERNELS:
        counts[k] += c[k]
    pace = "loader" if on > g1["ms"] else "device"
    log(f"[G1] loader {on:.1f} ms per batch with host augmentation "
        f"({off:.1f} without), step {g1['ms']:.2f} ms (busy "
        f"{busy_pct(g1['busy'])}), loader + step {loop:.1f} ms: the "
        f"{pace} sets the pace ({card})")

    # G2: env_corrupt and the time chain inside the step
    h2 = {**h1, "device_augment": True, "device_time_augment": "np"}
    g2 = time_device_augment("device np", h2, card)
    g2t = time_device_augment("device torch",
                              {**h2, "device_time_augment": "torch"}, card)
    banks = g2["banks"]
    errs = check_card_vs_cpu(banks, sr8)
    shares = env_shares(banks)
    for k in KERNELS:
        counts[k] += g2["counts"][k] + g2t["counts"][k]
    log(f"[G2] step: np {g2['ms']:.2f} ms (busy {busy_pct(g2['busy'])}), "
        f"torch {g2t['ms']:.2f} ms (busy {busy_pct(g2t['busy'])}), host "
        f"augment {g1['ms']:.2f} ms; loader + step: np {g2['loop_ms']:.1f} "
        f"ms, torch {g2t['loop_ms']:.1f} ms, host augment {loop:.1f} ms; "
        f"card vs CPU max abs {json.dumps(errs)}; "
        f"env shares over 65,536 rows {[round(s, 5) for s in shares]} "
        f"(.2/.4/.2/.2, within 4 sigma) ({card})")
    del g2, g2t, banks

    # G3: ECAPA_TDNN fed batches that its loader corrupted (env_corrupt on
    # the host's decode threads), SpecAugment after K1 in the step
    h3 = augmented({**ECAPA_TRAIN_HPARAMS, "train_annotation": str(
        tmp / "g3" / "meta" / "train.csv")}, ECAPA_AUGMENT, noise16)
    from speakerverification_tpu_torch.data.loader import train_data_loader
    from speakerverification_tpu_torch.ops import specaugment as sa
    loader3 = train_data_loader(h3)
    t0 = time.time()
    batches = [(b["wave"], b["label"]) for b in loader3]
    if loader3.augmentor is None or len(batches) < 2:
        fail(f"path G3: {len(batches)} batches, env_corrupt "
             f"{'on' if loader3.augmentor else 'off'} in the loader")
    log(f"[G3 loader] {len(batches)} batches of {batches[0][0].shape} with "
        f"env_corrupt in {time.time() - t0:.1f} s ({card})")
    state, step = train_state(h3, E_DEVICE)
    cfg = state.model.spec_augment
    if cfg is None:
        fail("path G3: spec_domain did not turn SpecAugment on")
    gen = torch.Generator(E_DEVICE).manual_seed(5)
    feats = torch.rand(256, 201, 80, device=E_DEVICE, generator=gen)
    d = sa.draw_spec_augment(gen, feats.shape, cfg)
    d_cpu = sa.SpecAugmentDraw(tuple(v.cpu() for v in d.warp),
                               type(d.time)(*(v.cpu() for v in d.time)),
                               type(d.freq)(*(v.cpu() for v in d.freq)))
    err = float((sa.apply_spec_augment(feats, d, cfg).cpu()
                 - sa.apply_spec_augment(feats.cpu(), d_cpu, cfg)).abs()
                .max())
    if err > 1e-6:
        fail(f"path G3: SpecAugment on the card differs from the CPU by {err}")
    reset_counts()
    g3 = time_steps("fp32 spec_domain", h3, card, tag="G3",
                    built=(state, step), step_args=(gen,), batch=batches[0])
    check_learning("fp32 spec_domain", h3, tag="G3", step_args=(gen,),
                   batch=batches[1])
    c = read_counts()
    for k in KERNELS:
        counts[k] += c[k]
    log(f"[G3] ECAPA_TDNN {h3['dataloader_options']['batch_size'] * 2} "
        f"crops x 32,000: SpecAugment card vs CPU max abs {err:.3e}; step "
        f"{g3['ms']:.2f} ms (busy {busy_pct(g3['busy'])}); launches {c} "
        f"({card})")
    del state, step

    # G4: --do_train --augment through the CLI, then --do_infer --eval
    g4 = path_e4(tmp / "g4", card, {**RAW3_TRAIN_HPARAMS, "augment_options":
                                    {**RAW3_AUGMENT, "augment_paths": noise8}},
                 tag="G4", train_args=("--augment",))
    for k in KERNELS:
        counts[k] += g4["counts"][k]
    log(f"[G] launches over G1-G4: {counts}")
    if counts["mel_frontend"] < 1 or counts["res2net_cascade"] \
            or counts["quant_matmul"]:
        fail(f"path G: unexpected launches {counts}")
    return {"counts": counts, "loader_ms": {"off": off, "host": on},
            "g1": g1, "loop_ms": loop, "epochs_s": g4["epochs_s"]}


# ----------------------------------------------------------------------
# path H: the data path (native reader, packed shards, cli.dataprep)
# ----------------------------------------------------------------------
# (name, audio_format, bits) of every format the readers take
WAV_FORMATS = (("pcm16", 1, 16), ("pcm24", 1, 24), ("pcm32", 1, 32),
               ("float32", 3, 32), ("float64", 3, 64))


def write_wav_format(path, fmt: str, channels: int, frames: int,
                     sr: int, seed: int) -> None:
    """A WAV of ``fmt`` with random samples over the format's range and a
    ``LIST`` chunk before ``fmt `` and after ``data``."""
    import struct

    import numpy as np
    rng = np.random.default_rng(seed)
    n = frames * channels
    audio_format, bits = {f: (a, b) for f, a, b in WAV_FORMATS}[fmt]
    if fmt == "pcm16":
        payload = rng.integers(-2**15, 2**15, n).astype("<i2").tobytes()
    elif fmt == "pcm24":
        v = rng.integers(-2**23, 2**23, n).astype("<i4")
        payload = np.ascontiguousarray(
            v.view(np.uint8).reshape(-1, 4)[:, :3]).tobytes()
    elif fmt == "pcm32":
        payload = rng.integers(-2**31, 2**31, n).astype("<i4").tobytes()
    else:
        payload = rng.uniform(-1.2, 1.2, n).astype(
            "<f4" if bits == 32 else "<f8").tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (tag + struct.pack("<I", len(body)) + body
                + b"\0" * (len(body) & 1))
    block = channels * bits // 8
    info = chunk(b"LIST", b"INFOISFT" + struct.pack("<I", 6) + b"smoke\0")
    body = (b"WAVE" + info
            + chunk(b"fmt ", struct.pack("<HHIIHH", audio_format, channels,
                                         sr, sr * block, block, bits))
            + chunk(b"data", payload) + info)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def path_h0(tmp, card: str) -> None:
    """The native reader builds, and decodes every format bit for bit as
    the NumPy parser does."""
    import numpy as np
    from speakerverification_tpu_torch.data import wavio
    t0 = time.time()
    if not wavio.native_available():
        fail(f"path H0: the native WAV reader did not build: "
             f"{wavio.native_error()}")
    build_s = time.time() - t0
    n = 0
    for i, (fmt, _, _) in enumerate(WAV_FORMATS):
        for ch in (1, 2):
            p = tmp / f"{fmt}_{ch}.wav"
            write_wav_format(p, fmt, ch, 16001, 16000, seed=10 * i + ch)
            got, sr = wavio.read_wav_native(p)
            want, sr_py = wavio._read_wav_python(p)
            if not (sr == sr_py == 16000 and got.shape == want.shape
                    == (16001,) and np.array_equal(got.view(np.uint32),
                                                   want.view(np.uint32))):
                fail(f"path H0: native and NumPy decoding of {fmt} x {ch} "
                     f"differ")
            n += 1
    log(f"[H0 reader] native library built and loaded in {build_s:.2f} s; "
        f"native == NumPy parser bit for bit on {n} files (PCM 16/24/32, "
        f"float32/64; mono and stereo; LIST chunks; odd length)")


def dataprep_cli(*args) -> tuple:
    """``cli.dataprep.main(args)`` in this process: its standard output
    and wall seconds."""
    import io
    from speakerverification_tpu_torch.cli.dataprep import main as dataprep
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = dataprep([str(a) for a in args])
    if rc != 0:
        fail(f"path H1: cli.dataprep {args} exited {rc}")
    return out.getvalue(), time.time() - t0


def write_config(path, h: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(h, indent=1))      # YAML's JSON subset
    return path


def check_pack(text: str, pack, manifest_csv, tag: str) -> dict:
    """The pack's printed stats against its manifest and its files."""
    from speakerverification_tpu_torch.data.manifest import Manifest
    stats = json.loads(text.strip().splitlines()[-1])
    on_disk = sum(f.stat().st_size for f in pack.glob("shard-*.bin"))
    n = len(Manifest.read(manifest_csv))
    if stats["utts"] != n or stats["bytes"] != on_disk or \
            stats["requantized"] != 0:
        fail(f"path {tag}: pack {stats} for {n} utterances, {on_disk} "
             f"bytes on disk")
    return stats


def check_noise_verbs(tmp, noise_root, sr: int) -> None:
    """``--stats``, ``--vad``, ``--restore`` and ``--split_musan`` on the
    noise corpus, each count held against one made here: the standard
    library's ``wave`` module for the files and their hours, the files
    left on disk, and the chunks a 5 s window every 3 s cuts."""
    import wave

    import numpy as np
    from speakerverification_tpu_torch.data.audio import write_wav
    cfg = write_config(tmp / "noise.yaml", {
        "data_folder": str(noise_root), "noise_folder": str(tmp / "musan_src"),
        "train_annotation": str(tmp / "unused" / "train.csv")})
    files = sorted(noise_root.rglob("*.wav"))
    seconds = 0.0
    for f in files:
        with wave.open(str(f), "rb") as w:
            seconds += w.getnframes() / w.getframerate()
    text, _ = dataprep_cli("--config", cfg, "--stats")
    stats = json.loads(text)
    if stats["n_files"] != len(files) or \
            abs(stats["total_hours"] - seconds / 3600) > 1e-9:
        fail(f"path H1: --stats {stats} against {len(files)} files, "
             f"{seconds} s")
    # stationary noise holds no voiced frame: tone bursts in silence are
    # added for --vad to find, and taken away after --restore
    rng = np.random.default_rng(50)
    tt = np.arange(3 * sr) / sr
    probes = noise_root / "vad_probe"
    for i in range(4):
        burst = (np.sin(2 * np.pi * 1.1 * tt) > 0) * 0.4 * np.sin(
            2 * np.pi * (180 + 40 * i) * tt)
        write_wav(probes / f"p{i}.wav", (burst + rng.normal(
            0, 0.003, tt.size)).astype(np.float32), sr)
    text, vad_s = dataprep_cli("--config", cfg, "--vad")
    n_vad = int(text.split("vad: ")[1].split()[0])
    made = sorted(noise_root.rglob("*_vad.wav"))
    text, _ = dataprep_cli("--config", cfg, "--restore")
    removed = int(text.split("removed ")[1].split()[0])
    for f in probes.iterdir():
        f.unlink()
    probes.rmdir()
    left = sorted(noise_root.rglob("*.wav"))
    if not (n_vad == len(made) == removed >= 4) or left != files:
        fail(f"path H1: --vad wrote {n_vad} ({len(made)} on disk, 4 probes "
             f"at least), --restore removed {removed}, {len(left)} of "
             f"{len(files)} files left")
    want = 0
    for i, secs in enumerate((9.5, 20.0, 31.0)):
        for cat in ("noise", "music", "speech"):
            n = int(secs * sr)
            write_wav(tmp / "musan_src" / "musan" / cat / "set" / f"{i}.wav",
                      rng.uniform(-0.3, 0.3, n).astype(np.float32), sr)
            want += len(range(0, n - 5 * sr, 3 * sr))
    text, _ = dataprep_cli("--config", cfg, "--split_musan")
    got = int(text.split("split_musan: ")[1].split()[0])
    on_disk = len(list((tmp / "musan_src" / "musan_split").rglob("*.wav")))
    if not got == on_disk == want:
        fail(f"path H1: --split_musan cut {got} chunks ({on_disk} on "
             f"disk), {want} expected")
    log(f"[H1 noise verbs] --stats {stats['n_files']} files, "
        f"{stats['total_hours']:.5f} h (wave module: {len(files)}, "
        f"{seconds / 3600:.5f}); --vad {n_vad} files (4 of them tone "
        f"bursts) in {vad_s:.2f} s, "
        f"--restore removed {removed}; --split_musan {got} chunks")


def read_costs(paths, spec, src, card: str, n: int = 1024) -> dict:
    """CPU ms per train crop on one thread, for each read path: the
    native reader and the NumPy parser (each decode then ``load_wav``'s
    crop), and a shard crop; and the file path's parts on their own: the
    file's bytes read, the NumPy decode of bytes already in memory, and
    the crop of audio already decoded."""
    from pathlib import Path

    import numpy as np
    from speakerverification_tpu_torch.data import wavio
    from speakerverification_tpu_torch.data.audio import load_wav
    n = min(n, len(paths))
    raw = [Path(p).read_bytes() for p in paths[:n]]
    decoded = [wavio._decode_wav(b)[0] for b in raw]

    def crop(audio, rng):
        return load_wav(audio, spec, evalmode=False, rng=rng,
                        normalize=False)
    ways = {"native": lambda i, rng: crop(
                wavio.read_wav_native(paths[i])[0], rng),
            "numpy": lambda i, rng: crop(
                wavio._read_wav_python(paths[i])[0], rng),
            "shard": lambda i, rng: src.crop_train(i, spec, rng=rng),
            "file read alone": lambda i, rng: Path(paths[i]).read_bytes(),
            "NumPy decode in memory": lambda i, rng: wavio._decode_wav(
                raw[i]),
            "crop alone": lambda i, rng: crop(decoded[i], rng)}
    out, crops = {}, {}
    for name, fn in ways.items():
        rng = np.random.default_rng(0)
        c0, t0 = time.process_time(), time.perf_counter()
        crops[name] = [fn(i, rng) for i in range(n)]
        out[name] = {"cpu_ms": (time.process_time() - c0) * 1e3 / n,
                     "wall_ms": (time.perf_counter() - t0) * 1e3 / n}
    for name in ("numpy", "shard", "crop alone"):
        if not all(np.array_equal(a, b) for a, b in
                   zip(crops[name], crops["native"])):
            fail(f"path H2: the {name} path's crops differ from the native "
                 f"reader's")
    sr, frames, _ = wavio.wav_info(paths[0])
    log(f"[H2 read cost] per crop on one thread over {n} crops of "
        f"{spec.max_audio} samples from {frames / sr:.1f} s files: "
        + ", ".join(
            f"{k} {v['cpu_ms']:.4f} ms CPU ({v['wall_ms']:.4f} wall)"
            for k, v in out.items()) + f"; crops equal ({card})")
    return out


def same_batches(h_files: dict, h_shards: dict, label: str,
                 n: int = 2) -> None:
    """The first ``n`` batches of the shard-fed loader equal the WAV-fed
    loader's, bit for bit (16-bit mono sources)."""
    import numpy as np
    from speakerverification_tpu_torch.data.loader import train_data_loader
    files, shards = train_data_loader(h_files), train_data_loader(h_shards)
    if shards.shard_source is None or files.shard_source is not None:
        fail("path H2: the loaders' sources are not as configured")
    for i, (a, b) in enumerate(zip(files, shards)):
        if i == n:
            break
        if not (np.array_equal(a["wave"], b["wave"])
                and np.array_equal(a["label"], b["label"])):
            fail(f"path H2: shard batch {i} differs from the WAV batch "
                 f"({label})")
    log(f"[H2 batches] {label}: the first {n} shard-fed batches equal the "
        f"WAV-fed ones bit for bit")


def fed_loop(h: dict, label: str, card: str, built, feed, steps: int = 8,
             step_args=()) -> float:
    """The train step fed by ``feed`` (a loader, or a list of batches in
    memory), as ``Trainer.train_epoch`` feeds it: ms per step over
    ``steps`` steps after 2, the window ending in one synchronize (the
    host queues the next step while the card runs this one)."""
    import torch
    state, step = built

    def batches():
        epoch = 1
        while True:
            if isinstance(feed, list):
                yield from feed
            else:
                feed.set_epoch(epoch)
                yield from feed
            epoch += 1
    it = batches()
    t0 = None
    for n, batch in enumerate(it, start=1):
        wave = torch.from_numpy(batch["wave"]).to(E_DEVICE)
        label_ = torch.from_numpy(batch["label"]).to(E_DEVICE)
        state, m = step(state, wave, label_, h["lr"], *step_args)
        if n == 2:
            torch.cuda.synchronize()
            t0 = time.time()
        if n == steps + 2:
            break
    torch.cuda.synchronize()
    ms = (time.time() - t0) / steps * 1e3
    it.close()
    log(f"[H3 loop {label}] {ms:.1f} ms per step over {steps} steps, loss "
        f"{float(m['loss']):.4f} ({card})")
    return ms


def path_h3(h_wav: dict, h_shard: dict, noise8: dict, card: str) -> dict:
    """The G1 step (64 crops, fp32, 8 kHz) alone and fed: by batches
    already in memory, by the native-WAV loader and the shard loader, and
    by the shard loader with ``device_augment`` in the step (G2's
    setting)."""
    import torch
    from speakerverification_tpu_torch.data.loader import train_data_loader
    from speakerverification_tpu_torch.training.trainer import (
        device_augmentation,
    )
    built = train_state(h_wav, E_DEVICE)
    alone = time_steps("fp32 alone", h_wav, card, tag="H3", built=built)
    native = train_data_loader(h_wav)
    feeds = {"in memory": [b for b, _ in zip(native, range(10))],
             "native WAV": native, "shards": train_data_loader(h_shard)}
    loops = {name: fed_loop(h_wav, name, card, built, feed)
             for name, feed in feeds.items()}
    del built, feeds
    h_dev = {**augmented(h_shard, RAW3_AUGMENT, noise8),
             "device_augment": True, "device_time_augment": "np"}
    loader = train_data_loader(h_dev)
    fn, banks, _ = device_augmentation(h_dev, loader, E_DEVICE)
    if loader.augmentor is not None or banks is None:
        fail("path H3: env_corrupt did not move to the device")
    built = train_state(h_dev, E_DEVICE, augment_fn=fn)
    gen = torch.Generator(E_DEVICE).manual_seed(1000)
    loops["shards + device_augment np"] = fed_loop(
        h_dev, "shards + device_augment np", card, built, loader,
        step_args=(gen, banks))
    floor = alone["ms"]
    log(f"[H3] step alone {floor:.2f} ms (busy {busy_pct(alone['busy'])});"
        f" fed, one sync: " + ", ".join(
            f"{k} {v:.1f} ms ({v - floor:+.1f})" for k, v in loops.items())
        + f" ({card})")
    return {"alone": alone, "loops": loops}


def path_h5(card: str) -> dict:
    """G3's ECAPA_TDNN-1024 step (256 x 32,000, AAmSoftmax over 5,994,
    without SpecAugment) with and without ``remat``: ms, peak memory, and
    each top-level module's gradient, card against card."""
    import torch
    h = dict(ECAPA_TRAIN_HPARAMS)
    hr = {**h, "model": {**h["model"], "remat": True}}
    out = {"plain": time_steps("no remat", h, card, tag="H5"),
           "remat": time_steps("remat", hr, card, tag="H5")}
    n_spk = int(h["dataloader_options"]["batch_size"])
    wave, label = seeded_batch(23, n_spk, 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    label = torch.from_numpy(label).to(E_DEVICE)
    grads = {}
    for key, hh in (("plain", h), ("remat", hr)):
        state, _ = train_state(hh, E_DEVICE)
        if state.model.backbone.remat != (key == "remat"):
            fail(f"path H5: model.remat did not reach the model ({key})")
        grads[key] = {k: g.detach().cpu() for k, g in
                      loss_grads(state, wave, label).items()}
        del state
    cos = {}
    for branch in sorted({k.split(".")[1] if k.startswith("backbone.")
                          else k.split(".")[0] for k in grads["plain"]}):
        keys = [k for k in grads["plain"]
                if k.startswith((f"backbone.{branch}.", f"{branch}."))]
        zeros = {k: 0 * grads["plain"][k] for k in keys}
        cos[branch] = update_cosine({k: grads["remat"][k] for k in keys},
                                    zeros, {k: grads["plain"][k]
                                            for k in keys})[0]
    low = min(cos.values())
    log(f"[H5] remat: {out['remat']['ms']:.2f} ms per step against "
        f"{out['plain']['ms']:.2f} (x{out['remat']['ms'] / out['plain']['ms']:.3f}), "
        f"peak {out['remat']['peak_gib']:.2f} GiB against "
        f"{out['plain']['peak_gib']:.2f}; gradient cosine remat vs not by "
        f"module (bar 0.99999): {json.dumps({k: round(v, 7) for k, v in cos.items()})} "
        f"{'ok' if low >= 0.99999 else 'FAIL'} ({card})")
    if low < 0.99999:
        fail("path H5: remat changes the gradient")
    out["cosines"] = cos
    return out


def path_h(tmp, card: str) -> dict:
    """The data path on the card (H0-H5): G's corpora prepared and packed
    by ``cli.dataprep``, the readers' cost, the loaders feeding the step,
    ``--do_train`` from shards, ``remat``."""
    from speakerverification_tpu_torch.data import shards
    corpora = g_corpora(tmp)
    noise8 = corpora["noise8"]
    hdir = tmp / "h"
    hdir.mkdir(exist_ok=True)
    path_h0(hdir, card)
    counts = dict.fromkeys(KERNELS, 0)

    # H1: prepare and pack
    base = {**RAW3_TRAIN_HPARAMS, "data_folder": str(tmp / "g1" / "data"),
            "train_annotation": str(hdir / "meta8" / "train.csv")}
    pack8 = hdir / "pack8"
    text, wall = dataprep_cli("--config",
                              write_config(hdir / "prep8.yaml", base),
                              "--generate", "--pack", pack8)
    gen = json.loads(text.strip().splitlines()[0])
    p8 = check_pack(text, pack8, base["train_annotation"], "H1")
    h16 = {**ECAPA_TRAIN_HPARAMS,
           "train_annotation": str(tmp / "g3" / "meta" / "train.csv")}
    pack16 = hdir / "pack16"
    text, wall16 = dataprep_cli("--config",
                                write_config(hdir / "prep16.yaml", h16),
                                "--pack", pack16)
    p16 = check_pack(text, pack16, h16["train_annotation"], "H1")
    log(f"[H1 prepare] --generate --pack at 8 kHz: {gen}, {p8['utts']} "
        f"utterances into {p8['shards']} shard(s) of {p8['bytes']} bytes, "
        f"requantized {p8['requantized']}, {wall:.2f} s; --pack at 16 kHz: "
        f"{p16['utts']} utterances, {p16['bytes']} bytes, requantized "
        f"{p16['requantized']}, {wall16:.2f} s ({card})")
    check_noise_verbs(hdir, tmp / "noise8k",
                      RAW3_TRAIN_HPARAMS["audio_spec"]["sample_rate"])

    # H2: the readers' cost on the host
    src = shards.ShardedAudioSource(pack8)
    from speakerverification_tpu_torch.data.audio import AudioSpec
    from speakerverification_tpu_torch.data.manifest import Manifest
    manifest = Manifest.read(base["train_annotation"])
    costs = read_costs(manifest.paths, AudioSpec(base["audio_spec"]), src,
                       card)
    h_shard = {**base, "dataloader_options": {
        **base["dataloader_options"], "shards": str(pack8)}}
    nw = int(base["dataloader_options"]["num_workers"])
    sweep = {}
    for src_name, hh in (("native WAV", base), ("shards", h_shard)):
        for aug in ("augment off", "host augment"):
            h_run = hh if aug == "augment off" else augmented(
                hh, RAW3_AUGMENT, noise8)
            for w in (1, nw):
                sweep[src_name, aug, w] = loader_epoch(
                    h_run, f"{src_name} {aug}", card, w, tag="H2")
    for (src_name, aug, w), v in sweep.items():
        if w == 1:
            many = sweep[src_name, aug, nw]
            log(f"[H2 loader threads] {src_name} {aug}: {v['ms']:.1f} ms "
                f"per batch on 1 thread ({v['cores']:.2f} cores busy), "
                f"{many['ms']:.1f} ms on {nw} ({many['cores']:.2f} cores "
                f"busy): x{v['ms'] / many['ms']:.2f} ({card})")
    same_batches(base, h_shard, "augment off")
    same_batches(augmented(base, RAW3_AUGMENT, noise8),
                 augmented(h_shard, RAW3_AUGMENT, noise8), "host augment")

    # H3: the loaders feeding the step
    reset_counts()
    h3 = path_h3(base, h_shard, noise8, card)
    c = read_counts()
    for k in KERNELS:
        counts[k] += c[k]

    # H4: --do_train from shards, then --do_infer --eval
    pack4 = tmp / "h4" / "pack"
    h4 = {**RAW3_TRAIN_HPARAMS, "dataloader_options": {
        **RAW3_TRAIN_HPARAMS["dataloader_options"], "shards": str(pack4)}}
    reads = []
    real = shards.ShardedAudioSource.crop_train

    def counted(self, *args, **kwargs):
        reads.append(1)
        return real(self, *args, **kwargs)
    shards.ShardedAudioSource.crop_train = counted
    try:
        h4_out = path_e4(tmp / "h4", card, h4, tag="H4",
                         prepare=lambda cfg: dataprep_cli(
                             "--config", cfg, "--pack", pack4))
    finally:
        shards.ShardedAudioSource.crop_train = real
    crops = h4_out["steps"] * int(h4["dataloader_options"]["batch_size"]) \
        * int(h4["dataloader_options"]["nPerSpeaker"])
    if len(reads) < crops:
        fail(f"path H4: {len(reads)} shard crops read for {crops} crops "
             f"trained on")
    log(f"[H4] --do_train read {len(reads)} crops from the shards for "
        f"{h4_out['steps']} steps ({crops} crops)")
    for k in KERNELS:
        counts[k] += h4_out["counts"][k]

    # H5: remat
    reset_counts()
    h5 = path_h5(card)
    c = read_counts()
    for k in KERNELS:
        counts[k] += c[k]
    log(f"[H] launches over H0-H5: {counts}")
    if counts["mel_frontend"] < 1 or counts["res2net_cascade"] \
            or counts["quant_matmul"]:
        fail(f"path H: unexpected launches {counts}")
    return {"counts": counts, "read_costs": costs, "h3": h3, "h5": h5,
            "epochs_s": h4_out["epochs_s"]}


# ----------------------------------------------------------------------
# path I: the Conformer family, served and trained
# ----------------------------------------------------------------------
# the keys of yaml/model_plot.yaml (Conformer + AAmSoftmaxAP over 5,994 +
# AdaBelief, 16 kHz, 2 s crops; tests/test_torch_port_conformer_cli.py
# holds them against the file). ECAPA_Conformer, which no yaml names,
# takes them with its builder's defaults
CONFORMER_HPARAMS = {
    "seed": 20220805,
    "audio_spec": {"sample_rate": 16000, "channels": 1, "sentence_len": 2.0,
                   "win_len": 0.025, "hop_len": 0.01},
    "n_mfcc": 80, "n_mels": 80, "features": "melspectrogram",
    "model": {"name": "Conformer", "feature_type": "melspectrogram",
              "nOut": 512},
    "num_eval": 20,
    "number_of_epochs": 500, "batch_size": 64, "lr": 0.003,
    "base_lr": 1e-8, "max_lr": 0.003, "step_size": 10, "shuffle": False,
    "random_chunk": True, "nClasses": 5994,
    "dataloader_options": {"batch_size": 64, "shuffle": False,
                           "num_workers": 8, "max_seg_per_spk": 1000,
                           "nPerSpeaker": 2, "split_ratio": -1},
    "criterion": {"name": "AAmSoftmaxAP", "margin": 0.2, "scale": 30},
    "optimizer": {"name": "AdaBelief", "weight_decay": 0.00002,
                  "lr_decay": 0.95},
    "callbacks": {"name": "cosine_annealinglr_pt", "base_lr": 1e-8,
                  "max_lr": 0.003},
    "early_stopping": False, "es_patience": 15, "augment": False,
    "save_model_last": True, "ckpt_interval_minutes": -1,
    "test_interval": -1,
}
ECAPA_CONFORMER_HPARAMS = {**CONFORMER_HPARAMS, "model": {
    "name": "ECAPA_Conformer", "feature_type": "melspectrogram",
    "nOut": 192}}
# K3's Dense route on path I at the serving batch (160 crops of 2 s: 201
# frames, 49 after the subsampling, so M = 160 x 49 = 7,840 rows): x as
# the wrapper gets it, N, launches per forward, the layer
# (tests/test_torch_port_conformer_cli.py holds (K, N) and the counts
# against the models)
CONFORMER_DENSE_SHAPES = [
    ((7840, 1024), 256, 12, "Conformer _FeedForward_0/1 Dense_1"),
    ((7840, 4864), 256, 1, "Conformer subsampling Dense_0"),
    ((160, 512), 512, 1, "Conformer Dense_0"),
    ((7840, 576), 144, 32, "ECAPA_Conformer _FeedForward_0/1 Dense_1"),
    ((7840, 55152), 144, 1, "ECAPA_Conformer subsampling Dense_0"),
]
# gradients zero by construction (a softmax ignores a shift of all its
# inputs: the attention's key bias, the pooling convs' biases and the
# BatchNorm bias before the Conformer's pooling conv, AngularProto's
# logit bias): update cosines leave them out
I_ZERO_GRAD = ("RelativeMultiHeadAttention_0.Dense_1.bias",
               "backbone.Conv_1.bias", "backbone.BatchNorm_0.bias",
               "AttentiveStatisticsPooling_0.Conv1d_0.Conv_0.bias",
               "AngularProto_0.b")


def dropout_off(model) -> None:
    """Every dropout of ``model`` at rate 0 (for card-against-CPU checks:
    the two devices' random streams differ)."""
    from speakerverification_tpu_torch.models.layers import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def peak_gib(fn) -> float:
    """Peak allocated device memory (GiB) over one call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _conformer_module(key: str) -> str:
    """A parameter's group for the gradient check: each conformer block,
    the subsampling, the pooling and head, the loss head."""
    parts = key.split(".")
    if parts[0] == "loss":
        return "loss"
    if parts[1] == "ConformerEncoder_0":
        return (".".join(parts[:3]) if parts[2].startswith("ConformerBlock_")
                else "backbone.ConformerEncoder_0 subsampling")
    return "backbone pooling and head"


def path_i1(card: str) -> dict:
    """Conformer (model_plot.yaml) over HTTP at 8 x 20 crops of 2 s, its
    throughput, peak memory and profile."""
    import numpy as np
    h = CONFORMER_HPARAMS
    i1 = serve_over_http("I1", h, bn_seed=30, device=E_DEVICE)
    engine = i1["engine"]
    waves = (0.1 * np.random.default_rng(31).normal(
        0, 1, (i1["n_crops"], i1["samples"]))).astype(np.float32)
    throughput("I1 Conformer", engine, waves, h["num_eval"], card)
    peak = peak_gib(lambda: engine.embed_fn(waves))
    log(f"[I1] peak memory of a served batch ({len(waves)} crops): "
        f"{peak:.2f} GiB ({card})")
    profile("I1", engine, waves)
    return {**i1, "waves": waves, "peak_gib": peak}


def path_i2(i1: dict, card: str) -> dict:
    """The same model with ``quant: int8`` through the engine (calibrated
    on the batch): 14 K3 Dense-route launches per forward at the table's
    shapes, held against the plain int8 path on the CPU (same scales) and
    the float path on the card."""
    import copy

    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.quant import make_int8_embed_fn
    h = {**CONFORMER_HPARAMS, "quant": "int8"}
    waves = i1["waves"]
    engine = InferenceEngine(h, device=E_DEVICE)
    randomize_bn_(engine.model, seed=30)
    engine.embed_fn(waves)                       # calibrates on this batch
    torch.cuda.synchronize()
    reset_counts()
    with quant_shape_log() as shapes:
        got = engine.embed_fn(waves).cpu().numpy()
        torch.cuda.synchronize()
    counts = read_counts()
    table = [r for r in CONFORMER_DENSE_SHAPES
             if r[3].startswith("Conformer ")]
    want = {"mel_frontend": 1, "res2net_cascade": 0,
            "quant_matmul": sum(r[2] for r in table)}
    log(f"[I2] Conformer int8, {len(engine.act_scales)} calibrated layers: "
        f"launches per forward {counts}")
    if counts != want or not log_quant_shapes(shapes, 1, table, "I2"):
        fail(f"path I2: expected {want} at the table's shapes, got {counts}")
    n_cpu = 2 * h["num_eval"]
    cpu = make_int8_embed_fn(copy.deepcopy(engine.model).cpu(),
                             act_scales=engine.act_scales)
    cos = cosines(got[:n_cpu], cpu(torch.from_numpy(waves[:n_cpu])).numpy())
    ok = bool(np.isfinite(got).all()) and cos.min() >= 0.999
    log(f"[I2] int8 on the card vs the plain int8 path on the CPU, same "
        f"scales, {n_cpu} crops: min cos {cos.min():.7f} (need >= 0.999) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path I2: int8 embeddings on the card disagree with the CPU")
    cos = cosines(got, i1["engine"].embed_fn(waves).cpu().numpy())
    ok = cos.min() >= 0.99
    log(f"[I2] int8 vs float embeddings on the card, {len(waves)} crops: "
        f"min cos {cos.min():.5f}, mean {cos.mean():.5f} (need >= 0.99) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path I2: int8 embeddings stray from the float path")
    throughput("I2 Conformer int8", engine, waves, h["num_eval"], card)
    profile("I2", engine, waves)
    return {"counts": counts}


def path_i3(dev, gen) -> list:
    """K3's Dense route at every Conformer and ECAPA_Conformer shape, fp32
    and bf16, bit for bit against its plain version, timed beside the
    plain version, the ``_int_mm`` chain, the float layer and the bound;
    then each model's sum per forward."""
    import torch
    rows = [check_quant_shape(dev, gen, x_shape, N, dtype, per_fwd, layer)
            for x_shape, N, per_fwd, layer in CONFORMER_DENSE_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]
    for model in ("Conformer", "ECAPA_Conformer"):
        for dt in ("float32", "bfloat16"):
            mine = [r for r, (_, _, _, layer) in zip(
                rows, [s for s in CONFORMER_DENSE_SHAPES for _ in (0, 1)])
                if layer.startswith(model + " ") and r["shape"].endswith(dt)]

            def total(key):
                return sum((r[key] or 0.0) * r["launches_per_forward"]
                           for r in mine)
            log(f"[I3 {model} per forward {dt}] K3 {total('ms'):.3f} ms, "
                f"bound {total('bound_ms'):.3f} ms, _int_mm chain "
                f"{total('library_ms'):.3f} ms, float layers "
                f"{total('float_ms'):.3f} ms, plain {total('plain_ms'):.3f} ms "
                f"over {sum(r['launches_per_forward'] for r in mine)} "
                f"launches")
    return rows


def module_cosines(got: dict, want: dict, group_of=None,
                   zero_grad=I_ZERO_GRAD) -> dict:
    """Cosine of two gradient trees by ``group_of`` group (default
    :func:`_conformer_module`), leaving out ``zero_grad``."""
    group_of = group_of or _conformer_module
    out = {}
    for group in sorted({group_of(k) for k in want}):
        keys = [k for k in want if group_of(k) == group]
        zeros = {k: 0 * want[k].detach().cpu() for k in keys}
        cos, worst, name = update_cosine({k: got[k] for k in keys}, zeros,
                                         {k: want[k] for k in keys},
                                         zero_grad)
        out[group] = {"cos": cos, "lowest": worst, "lowest_at": name}
    return out


def path_i4(card: str) -> dict:
    """The Conformer train step (model_plot.yaml: 64 x 2 crops of 2 s,
    AAmSoftmaxAP over 5,994, AdaBelief): the gradient by module and three
    fp32 steps on the card against the CPU from one state, dropout off
    (4 speakers x 2 crops); then the full step with dropout drawn from a
    generator on the card, timed in fp32 and bf16; learning on one
    batch."""
    import torch
    h = dict(CONFORMER_HPARAMS)
    lr = h["lr"]
    cpu, cpu_step = train_state(h, "cpu")
    card_state, card_step = train_state(h, E_DEVICE)
    for st in (cpu, card_state):
        dropout_off(st.model)
    copy_state(cpu, card_state)
    wave, label = seeded_batch(40, 4, 2, h)
    counts = dict.fromkeys(KERNELS, 0)

    def add_counts():
        for k, v in read_counts().items():
            counts[k] += v
    reset_counts()
    g_card = loss_grads(card_state, torch.from_numpy(wave).to(E_DEVICE),
                        torch.from_numpy(label).to(E_DEVICE))
    add_counts()
    g_cpu = loss_grads(cpu, torch.from_numpy(wave), torch.from_numpy(label))
    grad = module_cosines(g_card, g_cpu)
    ok = all(v["cos"] >= 0.999 for v in grad.values())
    log(f"[I4 gradient] card vs CPU at the initial state, dropout off, by "
        f"module (bar 0.999): " + json.dumps(grad) + (" ok" if ok
                                                       else " FAIL"))
    if not ok:
        fail("path I4: the card's gradient disagrees with the CPU's")
    rows = []
    for i in range(3):
        wave, label = seeded_batch(41 + i, 4, 2, h)
        copy_state(cpu, card_state)
        before = {k: p.detach().clone() for k, p in cpu.params.items()}
        reset_counts()
        card_state, mc = card_step(card_state,
                                   torch.from_numpy(wave).to(E_DEVICE),
                                   torch.from_numpy(label).to(E_DEVICE), lr)
        torch.cuda.synchronize()
        add_counts()
        cpu, mp = cpu_step(cpu, torch.from_numpy(wave),
                           torch.from_numpy(label), lr)
        lc, lp = float(mc["loss"]), float(mp["loss"])
        stats = max(float((card_state.batch_stats[k].cpu() - s).abs().max()
                          / s.abs().max()) for k, s in cpu.batch_stats.items())
        cos, worst, name = update_cosine(card_state.params, before,
                                         cpu.params, I_ZERO_GRAD)
        row = {"loss_card": lc, "loss_cpu": lp,
               "loss_rel": abs(lc - lp) / abs(lp), "stats_rel": stats,
               "update_cos": cos, "worst_tensor_cos": worst,
               "worst_tensor": name}
        log(f"[I4 step {i}] " + json.dumps(row))
        rows.append(row)
    ok = (all(r["loss_rel"] <= 2e-3 and r["stats_rel"] <= 2e-2
              and r["update_cos"] >= 0.9 for r in rows)
          and counts == {"mel_frontend": 4, "res2net_cascade": 0,
                         "quant_matmul": 0})
    log(f"[I4] card vs CPU over 3 steps, dropout off: max loss rel "
        f"{max(r['loss_rel'] for r in rows):.3e} (bar 2e-3), max stats rel "
        f"{max(r['stats_rel'] for r in rows):.3e} (bar 2e-2), min update cos "
        f"{min(r['update_cos'] for r in rows):.6f} (bar 0.9); launches "
        f"(1 gradient + 3 steps) {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path I4: the card's train steps disagree with the CPU's")
    del cpu, card_state
    gen = torch.Generator(device=E_DEVICE)
    reset_counts()
    gen.manual_seed(1)
    fp32 = time_steps("fp32 dropout", h, card, tag="I4", step_args=(gen,))
    gen.manual_seed(2)
    bf16 = time_steps("bf16 mixedprec dropout", {**h, "mixedprec": True},
                      card, tag="I4", step_args=(gen,))
    gen.manual_seed(3)
    check_learning("fp32 dropout", h, tag="I4", step_args=(gen,))
    timed = read_counts()
    # the timed steps of each (and the profiled ones), 20 learning steps:
    # K1 once a step
    if timed["mel_frontend"] < fp32["steps"] + bf16["steps"] + 20:
        fail(f"path I4: K1 launched {timed['mel_frontend']} times in the "
             f"timed steps")
    return {"counts": {k: counts[k] + timed[k] for k in KERNELS},
            "fp32": fp32, "bf16": bf16}


def path_i5(card: str) -> dict:
    """ECAPA_Conformer at its builder's defaults: one served batch (8 x 20
    crops of 2 s) on the card, its peak memory, 16 crops of it against the
    CPU; one train step (64 x 2 crops) with its peak memory."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    h = ECAPA_CONFORMER_HPARAMS
    engine = InferenceEngine(h, device=E_DEVICE)
    randomize_bn_(engine.model, seed=32)
    n_params = sum(p.numel() for p in engine.model.parameters())
    n = BATCH_UTTS * h["num_eval"]
    samples = int(h["audio_spec"]["sentence_len"]
                  * h["audio_spec"]["sample_rate"])
    waves = (0.1 * np.random.default_rng(33).normal(0, 1, (n, samples))
             ).astype(np.float32)
    engine.embed_fn(waves)                               # warm-up
    reset_counts()
    peak = peak_gib(lambda: engine.embed_fn(waves))
    counts = read_counts()
    want = {"mel_frontend": 1, "res2net_cascade": 0, "quant_matmul": 0}
    log(f"[I5] ECAPA_Conformer on {engine.device}: {n_params / 1e6:.2f} M "
        f"params; a served batch of {n} crops: peak memory {peak:.2f} GiB, "
        f"launches {counts} ({card})")
    if counts != want:
        fail(f"path I5: expected {want}, got {counts}")
    throughput("I5 ECAPA_Conformer", engine, waves, h["num_eval"], card)
    # cuDNN's untimed pick for the serving forward's Conv2d (a train
    # step once took a ~66 GiB FFT plan): its kernels by name
    profile("I5", engine, waves)
    compare_with_cpu(engine, waves[:16], "I5")
    del engine
    gen = torch.Generator(device=E_DEVICE).manual_seed(4)
    reset_counts()
    step = time_steps("fp32 dropout", h, card, tag="I5", steps=2, warmup=1,
                      step_args=(gen,))
    train = read_counts()
    return {"counts": {k: counts[k] + train[k] for k in KERNELS},
            "serve_peak_gib": peak, "step": step}


def path_i(tmp, card: str, dev, gen) -> dict:
    """The Conformer family (I1-I6): Conformer served over HTTP (I1) and
    in int8 (I2), K3's Dense route at both models' shapes (I3), the
    Conformer train step (I4), ECAPA_Conformer served and stepped (I5),
    ``--do_train`` then ``--do_infer --eval`` through the CLI (I6)."""
    walls = {}

    def timed_phase(phase, fn, *args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        walls[phase] = round(time.time() - t0, 1)
        return out

    i1 = timed_phase("I1", path_i1, card)
    i2 = timed_phase("I2", path_i2, i1, card)
    del i1["engine"]
    k3 = timed_phase("I3", path_i3, dev, gen)
    i4 = timed_phase("I4", path_i4, card)
    i5 = timed_phase("I5", path_i5, card)
    # 160 speakers: a few steps of 64 distinct speakers x 2 crops
    i6 = timed_phase("I6", path_e4, tmp, card, CONFORMER_HPARAMS, tag="I6",
                     epochs=1, n_spk=160)
    counts = {k: i1["counts"][k] + i2["counts"][k] + i4["counts"][k]
              + i5["counts"][k] + i6["counts"][k] for k in KERNELS}
    log(f"[I] launches over I1-I6: {counts}; wall by phase (s) {walls}, "
        f"{sum(walls.values()):.1f} s in all")
    int8 = sum(r[2] for r in CONFORMER_DENSE_SHAPES
               if r[3].startswith("Conformer "))
    if counts["res2net_cascade"] or counts["quant_matmul"] != int8 \
            or counts["mel_frontend"] < 1:
        fail(f"path I: unexpected launches {counts}")
    return {"counts": counts, "k3": k3, "fp32": i4["fp32"],
            "bf16": i4["bf16"], "i5": i5, "epochs_s": i6["epochs_s"]}


# ----------------------------------------------------------------------
# path J: the ResNetSE and TitaNet families, hybrids2, int8 of the
# RawNet2 family
# ----------------------------------------------------------------------
# yaml/ecapa_tdnn.yaml's keys (16 kHz, 2 s crops, 80 mels, AAmSoftmax over
# 5,994, AdaBelief) with model.name ResNetSE34V2 at its builder's nOut 256;
# 20 crops an utterance (160 a served batch, as F1 and I1) and 64 speakers
# x 2 crops a step (the yaml's 128 halved, as I4's)
RESNETSE_HPARAMS = {
    **ECAPA_TRAIN_HPARAMS, "num_eval": 20, "batch_size": 64,
    "dataloader_options": {**ECAPA_TRAIN_HPARAMS["dataloader_options"],
                           "batch_size": 64},
    "model": {"name": "ResNetSE34V2", "feature_type": "melspectrogram",
              "nOut": 256},
    "save_model_last": True, "ckpt_interval_minutes": -1,
    "test_interval": -1,
}
# path J3: each model at its builder's defaults (nOut; TitaNet size L)
# with J1's keys; the hybrids featurize in-model (features: raw)
ZOO_MODELS = {
    "TitaNet": {"name": "TitaNet", "feature_type": "melspectrogram",
                "nOut": 512},
    "Tita_ECAPA": {"name": "Tita_ECAPA", "feature_type": "raw", "nOut": 512},
    "Raw_tita": {"name": "Raw_tita", "feature_type": "raw", "nOut": 512},
    "Res_ECAPA": {"name": "Res_ECAPA", "feature_type": "melspectrogram",
                  "nOut": 128},
}


def zoo_hparams(name: str) -> dict:
    model = ZOO_MODELS[name]
    return {**RESNETSE_HPARAMS, "features": model["feature_type"],
            "model": model}


# K3 at path J's new shapes at the serving batch (160 crops of 2 s at
# 16 kHz): x as the wrapper gets it, N, launches per forward, the layer
# (tests/test_torch_port_zoo_cli.py holds them against the models)
ZOO_QUANT_SHAPES = [
    ((160, 768, 1185), 256, 1,
     "Raw_ECAPA_conv_asp RawNetBasicBlock_2/Conv_2 (3-tap)"),
    ((160, 768, 395), 256, 4,
     "Raw_ECAPA_conv_asp RawNetBasicBlock_3-4/Conv_0-1 (3-tap)"),
    ((160, 768, 131), 512, 1,
     "Raw_ECAPA_conv_asp RawNetBasicBlock_5/Conv_1 (3-tap)"),
    ((160, 1536, 131), 512, 1,
     "Raw_ECAPA_conv_asp RawNetBasicBlock_5/Conv_2 (3-tap)"),
    ((160, 1536, 43), 512, 4,
     "Raw_ECAPA_conv_asp RawNetBasicBlock_6-7/Conv_0-1 (3-tap)"),
    ((160, 512), 512, 3, "Raw_ECAPA_conv_asp AFMS Dense_0"),
    ((160, 512, 14), 128, 1, "Raw_ECAPA_conv_asp raw Conv_1 (attention)"),
    ((160, 1024), 320, 1, "Raw_ECAPA_conv_asp raw Dense_0"),
    ((160, 2560, 26), 128, 1, "ResNetSE34V2 Conv_1 (attention)"),
    ((160, 5120), 256, 1, "ResNetSE34V2 Dense_0"),
]


def crop_samples(h: dict) -> int:
    """The samples of one crop of ``h``'s ``audio_spec``."""
    spec = h["audio_spec"]
    return int(spec["sentence_len"] * spec["sample_rate"])


def zoo_quant_table(model: str) -> list:
    """The K3 shapes of one int8 forward of ``model``: the table's rows,
    and for Raw_ECAPA_conv_asp its ECAPA branch's (path C's shapes: both
    ECAPAs see 201 frames)."""
    rows = [r for r in ZOO_QUANT_SHAPES if r[3].startswith(model + " ")]
    if model == "Raw_ECAPA_conv_asp":
        rows += [r for r in QUANT_SHAPES if r[3].startswith("ECAPA ")]
    return rows


def _zoo_module(key: str) -> str:
    """A parameter's group for the gradient check: the loss head, else
    the backbone's top-level module (a block, the stem, the pooling)."""
    parts = key.split(".")
    return "loss" if parts[0] == "loss" else ".".join(parts[:2])


# gradients zero by construction: a shift of the pooling's attention under
# its softmax over time (ResNetSE's last attention conv and the BN before
# it, TitaNet's energy Dense), a bias before a train-mode BatchNorm
# (every TitaNet conv, the depthwise one through its 1x1; the Dense and
# BN before the output BN)
J_ZERO_GRAD = {
    "ResNetSE34V2": ("backbone.Conv_2.bias", "backbone.BatchNorm_1.bias"),
    "TitaNet": ("backbone.Dense_0.bias", "backbone.Dense_2.bias",
                "backbone.BatchNorm_0.bias", "Conv_0.bias", "Conv_1.bias"),
}


def path_j1(card: str) -> dict:
    """ResNetSE34V2 (ecapa_tdnn.yaml's keys) over HTTP at 8 x 20 crops of
    2 s, its throughput, peak memory and profile; then the same model on
    ``mfcc`` and ``spectrogram`` features (the plain frontend: K1 is
    mel-only), 16 crops against the CPU and a timed forward each."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    h = RESNETSE_HPARAMS
    j1 = serve_over_http("J1", h, bn_seed=50, device=E_DEVICE)
    engine = j1["engine"]
    waves = (0.1 * np.random.default_rng(51).normal(
        0, 1, (j1["n_crops"], j1["samples"]))).astype(np.float32)
    throughput("J1 ResNetSE34V2", engine, waves, h["num_eval"], card)
    peak = peak_gib(lambda: engine.embed_fn(waves))
    log(f"[J1] peak memory of a served batch ({len(waves)} crops): "
        f"{peak:.2f} GiB ({card})")
    profile("J1", engine, waves)
    counts = dict(j1["counts"])
    for features in ("mfcc", "spectrogram"):
        hf = {**h, "features": features,
              "model": {**h["model"], "feature_type": features}}
        e = InferenceEngine(hf, device=E_DEVICE)
        randomize_bn_(e.model, seed=52)
        e.embed_fn(waves[:16])
        torch.cuda.synchronize()
        reset_counts()
        compare_with_cpu(e, waves[:16], f"J1 {features}")
        got = read_counts()
        if any(got.values()):
            fail(f"path J1 {features}: kernels launched {got} (the mel "
                 "kernel is melspectrogram-only)")
        throughput(f"J1 ResNetSE34V2 {features}", e, waves, h["num_eval"],
                   card)
        del e
    return {**j1, "counts": counts, "waves": waves, "peak_gib": peak}


def int8_served(tag: str, h: dict, waves, float_emb, table,
                bn_seed: int, card: str, mel: int = 1,
                cascade: int = 0) -> dict:
    """``h`` with ``quant: int8`` through the engine (calibrated on the
    batch): K3's launches at ``table``'s shapes (and ``mel`` and
    ``cascade`` launches of K1 and K2 per forward), the embeddings
    against the plain int8 path on the CPU (same scales) and
    ``float_emb``."""
    import copy

    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.quant import make_int8_embed_fn
    engine = InferenceEngine({**h, "quant": "int8"}, device=E_DEVICE)
    randomize_bn_(engine.model, seed=bn_seed)
    engine.embed_fn(waves)                       # calibrates on this batch
    torch.cuda.synchronize()
    reset_counts()
    with quant_shape_log() as shapes:
        got = engine.embed_fn(waves).cpu().numpy()
        torch.cuda.synchronize()
    counts = read_counts()
    want = {"mel_frontend": mel, "res2net_cascade": cascade,
            "quant_matmul": sum(r[2] for r in table)}
    log(f"[{tag}] {h['model']['name']} int8, {len(engine.act_scales)} "
        f"calibrated layers: launches per forward {counts}")
    if counts != want or not log_quant_shapes(shapes, 1, table, tag):
        fail(f"path {tag}: expected {want} at the table's shapes, got "
             f"{counts}")
    n_cpu = 16
    cpu = make_int8_embed_fn(copy.deepcopy(engine.model).cpu(),
                             act_scales=engine.act_scales)
    cos = cosines(got[:n_cpu], cpu(torch.from_numpy(waves[:n_cpu])).numpy())
    ok = bool(np.isfinite(got).all()) and cos.min() >= 0.999
    log(f"[{tag}] int8 on the card vs the plain int8 path on the CPU, same "
        f"scales, {n_cpu} crops: min cos {cos.min():.7f} (need >= 0.999) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"path {tag}: int8 embeddings on the card disagree with the CPU")
    cos = cosines(got, float_emb)
    ok = cos.min() >= 0.99
    log(f"[{tag}] int8 vs float embeddings on the card, {len(waves)} crops: "
        f"min cos {cos.min():.5f}, mean {cos.mean():.5f} (need >= 0.99) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"path {tag}: int8 embeddings stray from the float path")
    throughput(f"{tag} {h['model']['name']} int8", engine, waves,
               h["num_eval"], card)
    return counts


def path_j2(j1: dict, dev, gen, card: str) -> dict:
    """int8: ResNetSE34V2 (J1's weights) and Raw_ECAPA_conv_asp
    (voxceleb_raw_ecapa.yaml) served with ``quant: int8``; then K3 at
    every new shape, fp32 and bf16, bit for bit and timed."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    counts = dict.fromkeys(KERNELS, 0)
    waves = j1["waves"]
    float_emb = j1["engine"].embed_fn(waves).cpu().numpy()
    for k, v in int8_served("J2", RESNETSE_HPARAMS, waves, float_emb,
                            zoo_quant_table("ResNetSE34V2"), 50,
                            card).items():
        counts[k] += v
    h = RAW_ECAPA_HPARAMS
    raw_waves = (0.1 * np.random.default_rng(53).normal(0, 1, (
        BATCH_UTTS * h["num_eval"], crop_samples(h)))).astype(np.float32)
    engine = InferenceEngine(h, device=E_DEVICE)
    randomize_bn_(engine.model, seed=54)
    float_emb = engine.embed_fn(raw_waves).cpu().numpy()
    del engine
    for k, v in int8_served("J2", h, raw_waves, float_emb,
                            zoo_quant_table("Raw_ECAPA_conv_asp"), 54,
                            card).items():
        counts[k] += v
    rows = [check_quant_shape(dev, gen, x_shape, N, dtype, per_fwd, layer)
            for x_shape, N, per_fwd, layer in ZOO_QUANT_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]
    labels = [s for s in ZOO_QUANT_SHAPES for _ in (0, 1)]
    for model in ("ResNetSE34V2", "Raw_ECAPA_conv_asp"):
        for dt in ("float32", "bfloat16"):
            mine = [r for r, (_, _, _, layer) in zip(rows, labels)
                    if layer.startswith(model + " ")
                    and r["shape"].endswith(dt)]

            def total(key):
                return sum((r[key] or 0.0) * r["launches_per_forward"]
                           for r in mine)
            log(f"[J2 {model} new shapes per forward {dt}] K3 "
                f"{total('ms'):.3f} ms, bound {total('bound_ms'):.3f} ms, "
                f"_int_mm chain {total('library_ms'):.3f} ms, float layers "
                f"{total('float_ms'):.3f} ms, plain {total('plain_ms'):.3f} "
                f"ms over {sum(r['launches_per_forward'] for r in mine)} "
                f"launches")
    return {"counts": counts, "k3": rows}


def path_j3(card: str) -> dict:
    """TitaNet-L, Tita_ECAPA, Raw_tita and Res_ECAPA at their builders'
    defaults: one served batch (8 x 20 crops of 2 s) each on the card,
    its launches, forward ms and peak memory, 16 crops against the CPU."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    counts = dict.fromkeys(KERNELS, 0)
    out = {}
    for i, name in enumerate(ZOO_MODELS):
        h = zoo_hparams(name)
        engine = InferenceEngine(h, device=E_DEVICE)
        randomize_bn_(engine.model, seed=60 + i)
        n_params = sum(p.numel() for p in engine.model.parameters())
        waves = (0.1 * np.random.default_rng(60 + i).normal(0, 1, (
            BATCH_UTTS * h["num_eval"], crop_samples(h)))).astype(np.float32)
        engine.embed_fn(waves)                           # warm-up
        torch.cuda.synchronize()
        reset_counts()
        peak = peak_gib(lambda: engine.embed_fn(waves))
        got = read_counts()
        want = {"mel_frontend": 1, "res2net_cascade": 0, "quant_matmul": 0}
        log(f"[J3] {name} on {engine.device}: {n_params / 1e6:.2f} M params;"
            f" a served batch of {len(waves)} crops: peak memory "
            f"{peak:.2f} GiB, launches {got} ({card})")
        if got != want:
            fail(f"path J3 {name}: expected {want}, got {got}")
        for k, v in got.items():
            counts[k] += v
        throughput(f"J3 {name}", engine, waves, h["num_eval"], card)
        compare_with_cpu(engine, waves[:16], f"J3 {name}")
        out[name] = {"peak_gib": peak, "params": n_params}
        del engine
    return {"counts": counts, "models": out}


def path_j4(card: str) -> dict:
    """The 64 x 2-crop AAmSoftmax (5,994) + AdaBelief step of ResNetSE34V2
    and TitaNet-L: the gradient by module on the card against the CPU
    from one state (4 speakers x 2 crops, dropout off), then the full
    step timed in fp32 and bf16 (TitaNet's dropout drawn from a
    generator on the card), peak memory and busy share."""
    import torch
    counts = dict.fromkeys(KERNELS, 0)
    out = {}
    for name, h in (("ResNetSE34V2", RESNETSE_HPARAMS),
                    ("TitaNet", zoo_hparams("TitaNet"))):
        cpu, _ = train_state(h, "cpu")
        card_state, _ = train_state(h, E_DEVICE)
        for st in (cpu, card_state):
            dropout_off(st.model)
        copy_state(cpu, card_state)
        wave, label = seeded_batch(70, 4, 2, h)
        reset_counts()
        g_card = loss_grads(card_state, torch.from_numpy(wave).to(E_DEVICE),
                            torch.from_numpy(label).to(E_DEVICE))
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            counts[k] += v
        g_cpu = loss_grads(cpu, torch.from_numpy(wave),
                           torch.from_numpy(label))
        grad = module_cosines(g_card, g_cpu, _zoo_module,
                              J_ZERO_GRAD[name])
        low = min(v["cos"] for v in grad.values())
        ok = low >= 0.999
        log(f"[J4 {name} gradient] card vs CPU at the initial state, dropout"
            f" off, {len(grad)} modules, lowest cos {low:.7f} (bar 0.999): "
            + json.dumps(grad) + (" ok" if ok else " FAIL"))
        if not ok:
            fail(f"path J4 {name}: the card's gradient disagrees with the "
                 "CPU's")
        del cpu, card_state
        gen = torch.Generator(device=E_DEVICE)
        reset_counts()
        gen.manual_seed(5)
        fp32 = time_steps(f"{name} fp32", h, card, tag="J4",
                          step_args=(gen,))
        gen.manual_seed(6)
        bf16 = time_steps(f"{name} bf16 mixedprec", {**h, "mixedprec": True},
                          card, tag="J4", step_args=(gen,))
        timed = read_counts()
        if timed["mel_frontend"] < fp32["steps"] + bf16["steps"]:
            fail(f"path J4 {name}: K1 launched {timed['mel_frontend']} "
                 "times in the timed steps")
        for k, v in timed.items():
            counts[k] += v
        out[name] = {"fp32": fp32, "bf16": bf16}
    return {"counts": counts, **out}


def path_j(tmp, card: str, dev, gen) -> dict:
    """The tenth slice (J1-J5): ResNetSE34V2 over HTTP with its mfcc and
    spectrogram variants (J1), int8 of ResNetSE34V2 and
    Raw_ECAPA_conv_asp with K3 at every new shape (J2), TitaNet-L,
    Tita_ECAPA, Raw_tita and Res_ECAPA served (J3), the ResNetSE34V2 and
    TitaNet-L train steps (J4), ``--do_train`` then ``--do_infer --eval``
    through the CLI (J5)."""
    walls = {}

    def timed_phase(phase, fn, *args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        walls[phase] = round(time.time() - t0, 1)
        return out

    j1 = timed_phase("J1", path_j1, card)
    j2 = timed_phase("J2", path_j2, j1, dev, gen, card)
    del j1["engine"]
    j3 = timed_phase("J3", path_j3, card)
    j4 = timed_phase("J4", path_j4, card)
    j5 = timed_phase("J5", path_e4, tmp, card, RESNETSE_HPARAMS, tag="J5",
                     epochs=1, n_spk=160)
    counts = {k: j1["counts"][k] + j2["counts"][k] + j3["counts"][k]
              + j4["counts"][k] + j5["counts"][k] for k in KERNELS}
    log(f"[J] launches over J1-J5: {counts}; wall by phase (s) {walls}, "
        f"{sum(walls.values()):.1f} s in all")
    int8 = (sum(r[2] for r in zoo_quant_table("ResNetSE34V2"))
            + sum(r[2] for r in zoo_quant_table("Raw_ECAPA_conv_asp")))
    if counts["res2net_cascade"] or counts["quant_matmul"] != int8 \
            or counts["mel_frontend"] < 1:
        fail(f"path J: unexpected launches {counts}")
    return {"counts": counts, "k3": j2["k3"], "j3": j3["models"],
            "j4": {k: j4[k] for k in ("ResNetSE34V2", "TitaNet")},
            "epochs_s": j5["epochs_s"]}


# ----------------------------------------------------------------------
# path L: the loss and optimizer zoos on the default stack
# ----------------------------------------------------------------------
# the eleventh slice's heads and optimizers (the JAX registries' names
# that the port lacked before it; ShardedAAmSoftmax needs model_parallel)
L_HEADS = ("AngularPenaltySMLoss", "adasoftmax_v1", "adasoftmax_v2",
           "ProxyAnchor", "ProxyNCA", "MP", "MMP", "MP_Balance",
           "MMP_Balance", "MMP_Balance_MTL", "MultiSimilarity",
           "MultiSimilarity_v2", "MSSoftmax", "MSAmSoftmax", "CircleLoss",
           "CircleLossV2", "TripletLoss")
L_OPTIMIZERS = (
    ("SGDW", {}), ("QHM", {}), ("QHAdam", {}), ("DiffGrad", {}),
    ("MADGRAD", {}), ("AdaBound", {}), ("AdaMod", {}), ("AdamP", {}),
    ("SGDP", {}), ("AggMo", {}), ("PID", {"momentum": 0.9}), ("AccSGD", {}),
    ("SWATS", {}), ("RAdam", {}), ("Lamb", {}), ("LARS", {"momentum": 0.9}),
    ("NovoGrad", {}), ("Adafactor", {}), ("Yogi", {}), ("Lookahead", {}),
    ("Lookahead", {"inner": "AdaBelief"}), ("Adahessian", {}),
    ("Shampoo", {}), ("Apollo", {}), ("A2GradUni", {}))
# a head's gradient that is zero by construction (MP's logit bias shifts
# every logit of its two softmaxes): rounding noise on both devices
L_ZERO_GRAD = {("MP", "b"), ("MP_Balance", "b")}
# Shampoo's card-vs-CPU check covers the leaves whose axes are all <=
# this (272 of the 275: the head's W [512, 13,103] and two 1x1 conv
# kernels with 4,608 inputs are left out)
L_SHAMPOO_CPU_AXIS = 4096
# the whole script's L3 runs Shampoo on the head's first 2,048 classes
# (its 13,103-class update is one ~38 s SVD) and holds the leaves with
# every axis <= 512 (224 of 275: the raw branch's 1,024-wide leaves are
# left out) against the CPU, whose update of the leaves up to 4,096 took
# 97 s on a slow host and of those up to 1,024, with the float64 referee,
# 22.8 s; ``--train-zoo`` keeps both
L_SHAMPOO_WHOLE_RUN = {"shampoo_classes": 2048, "shampoo_cpu_axis": 512}
# L2's steps per head and L3's train steps per optimizer; the whole script
# takes 6 and 3 (path L alone 10 and 5): every head that falls in PR
# 16's runs fell within its first 6 steps
L2_STEPS, L3_STEPS = 10, 5
# L3's updates held card against CPU per optimizer (the whole script: 2)
L3_UPDATES = 3
# a divergent head's loss on the card against the CPU's (path L2): at
# step 0, on the same weights, within this relative difference; after the
# first step, within this factor either way (see path_l2)
L2_DIVERGE_STEP0_REL = 5e-2
L2_DIVERGE_AFTER_FACTOR = 4.0


def l_head(name: str, h: dict, seed: int = 1):
    """The head ``name`` at the stack's width, drawn from ``seed`` on the
    CPU (the config's criterion keys where it names this head)."""
    import torch
    from speakerverification_tpu_torch.losses import build_loss
    from speakerverification_tpu_torch.weights import init_weights_
    crit = dict(h.get("criterion", {}))
    kw = {k: v for k, v in crit.items() if k != "name"} \
        if crit.get("name") == name else {}
    head = build_loss(name, nOut=int(h["model"]["nOut"]),
                      nClasses=int(h["nClasses"]), **kw)
    return init_weights_(head, torch.Generator().manual_seed(seed))


def l_stack(h: dict):
    """The default stack on the card (its weights drawn as flax draws
    them) and a copy of its trunk's initial state, to reset it from."""
    from speakerverification_tpu_torch.builder import encoder_from_hparams
    from speakerverification_tpu_torch.weights import init_weights_
    import torch
    model = encoder_from_hparams(h, with_loss=True)
    init_weights_(model, torch.Generator().manual_seed(7))
    model = model.to(E_DEVICE)
    trunk = {k: v.detach().clone() for k, v in model.state_dict().items()
             if not k.startswith("loss.")}
    return model, trunk


def l_reset(model, trunk: dict, head, tx):
    """``model`` back to the trunk's initial state with ``head`` on it,
    and a fresh train state and step for the optimizer ``tx``."""
    import torch
    from speakerverification_tpu_torch.training.state import (
        TrainState,
        model_state,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    with torch.no_grad():
        sd = model.state_dict()
        for k, v in trunk.items():
            sd[k].copy_(v)
    model.loss = head.to(E_DEVICE)
    params, stats = model_state(model)
    state = TrainState(0, params, stats,
                       tx.init({k: p.detach() for k, p in params.items()}),
                       model)
    return state, make_train_step(model, tx)


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def _cos(a, b) -> float:
    a, b = a.detach().double().cpu().ravel(), b.detach().double().cpu().ravel()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


def l_head_run(name: str, head, emb, label, negidx=None):
    """``(loss, prec1, grads)`` of ``head`` on the embeddings ``emb``, the
    gradients with respect to them (``x``) and to each head parameter;
    TripletLoss through its function of given negatives."""
    import torch
    from speakerverification_tpu_torch.losses.common import l2_normalize
    from speakerverification_tpu_torch.losses.triplet import (
        triplet_from_indices,
    )
    x = emb.detach().clone().requires_grad_(True)
    if negidx is not None:
        loss, prec = triplet_from_indices(
            l2_normalize(x[:, 0], -1), l2_normalize(x[:, 1], -1),
            negidx.to(x.device), head.margin)
    else:
        loss, prec = head(x, label)
    named = list(head.named_parameters())
    grads = {}
    if torch.isfinite(loss):
        gs = torch.autograd.grad(loss, [x] + [p for _, p in named])
        grads = dict(zip(["x"] + [n for n, _ in named], gs))
    return float(loss.detach()), float(prec), grads


def path_l1(h: dict, model, wave, label) -> dict:
    """Each head on the embeddings of one training forward of the trunk,
    on the card and on the CPU from the same weights: loss and prec1 to
    1e-5 relative, the gradients (embeddings, head parameters) to cosine
    0.9999; a loss that is not finite on the CPU must not be on the card
    either."""
    import copy

    import torch
    from speakerverification_tpu_torch.losses.triplet import (
        MINING_SEED,
        mine_negatives,
    )
    from speakerverification_tpu_torch.losses.common import l2_normalize
    model.train()
    reset_counts()
    with torch.no_grad():
        emb = model(wave)
    torch.cuda.synchronize()
    counts = read_counts()
    norms = emb.norm(dim=-1)
    log(f"[L1] embeddings {tuple(emb.shape)} of one training forward: norms "
        f"{float(norms.min()):.3f}-{float(norms.max()):.3f} (mean "
        f"{float(norms.mean()):.3f})")
    rows, ok_all = {}, True
    for name in L_HEADS:
        head_cpu = l_head(name, h)
        head_card = copy.deepcopy(head_cpu).to(E_DEVICE)
        negidx = None
        if name == "TripletLoss":
            a = l2_normalize(emb[:, 0], -1)
            p = l2_normalize(emb[:, 1], -1)
            d2 = ((a ** 2).sum(-1)[:, None] + (p ** 2).sum(-1)[None, :]
                  - 2 * a @ p.T)
            negidx = mine_negatives(
                -d2, head_card.hard_rank, head_card.hard_prob,
                head_card.margin, torch.Generator(device=emb.device)
                .manual_seed(MINING_SEED))
        lc, pc, gc = l_head_run(name, head_card, emb, label, negidx)
        lp, pp, gp = l_head_run(name, head_cpu, emb.cpu(), label.cpu(),
                                None if negidx is None else negidx.cpu())
        row = {"loss_card": lc, "loss_cpu": lp, "prec1_card": pc,
               "prec1_cpu": pp}
        if _finite(lp):
            row["loss_rel"] = abs(lc - lp) / max(abs(lp), 1e-30)
            row["prec1_rel"] = abs(pc - pp) / max(abs(pp), 1e-30)
            fin = {k: bool(torch.isfinite(g).all()) for k, g in gp.items()}
            same = all(fin[k] == bool(torch.isfinite(gc[k]).all())
                       for k in gp)
            cos = {k: _cos(gc[k], gp[k]) for k in gp
                   if (name, k) not in L_ZERO_GRAD and fin[k]}
            row["grad_cos_min"] = min(cos.values(), default=1.0)
            row["grad_cos_min_at"] = min(cos, key=cos.get, default="")
            if not all(fin.values()):
                # a masked exp that overflows: its zero cotangent times
                # inf is NaN, on both devices alike (and in JAX)
                row["non_finite_grads"] = sorted(k for k in fin
                                                 if not fin[k])
            ok = (same and row["loss_rel"] <= 1e-5
                  and (pc == pp or row["prec1_rel"] <= 1e-5)
                  and row["grad_cos_min"] >= 0.9999)
        else:
            ok = not _finite(lc)
            row["non_finite_on_both"] = ok
        rows[name] = row
        ok_all &= ok
        log(f"[L1 {name}] " + json.dumps(row) + (" ok" if ok else " FAIL"))
    if not ok_all:
        fail("path L1: a head on the card disagrees with the CPU")
    return {"counts": counts, "norms": (float(norms.min()),
                                        float(norms.max())), "heads": rows}


def l_head_breaks(model, snapshot: dict, wave, label) -> tuple:
    """``(card, cpu)``: whether the head's loss or its gradients (with
    respect to the embeddings and its parameters) are not finite on the
    forward of ``snapshot`` (a state a step began from), on the card and
    on the CPU."""
    import copy

    import torch
    with torch.no_grad():
        model.load_state_dict(snapshot)
        model.train()
        emb = model(wave)
    out = []
    for head, e, lab in ((model.loss, emb, label),
                         (copy.deepcopy(model.loss).cpu(), emb.cpu(),
                          label.cpu())):
        loss, _, grads = l_head_run("", head, e, lab)
        out.append(not _finite(loss) or not all(
            bool(torch.isfinite(g).all()) for g in grads.values()))
    return tuple(out)


def l_cpu_first_two(h: dict, model, start: dict, wave, label) -> list:
    """The loss of the first train step from ``start`` and the loss after
    it, on the CPU's plain path (the same batch, weights and optimizer);
    ``model`` is left at ``start``."""
    import copy

    import torch
    from speakerverification_tpu_torch.builder import optimizer_from_hparams
    from speakerverification_tpu_torch.training.state import (
        TrainState,
        model_state,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    with torch.no_grad():
        model.load_state_dict(start)
    cpu = copy.deepcopy(model).cpu()
    tx = optimizer_from_hparams(h)
    params, stats = model_state(cpu)
    state = TrainState(0, params, stats, tx.init(
        {k: p.detach() for k, p in params.items()}), cpu)
    state, m = make_train_step(cpu, tx)(state, wave.cpu(), label.cpu(),
                                        h["lr"])
    with torch.no_grad():
        after, _ = cpu(wave.cpu(), label.cpu())
    return [float(m["loss"]), float(after)]


def path_l2(h: dict, model, trunk, wave, label, card: str) -> dict:
    """Each head on the default stack's train step (AdaBelief),
    ``L2_STEPS`` steps on one fixed batch: the loss stays finite and
    falls (the mean of the last three below the loss at step 0, of the
    initial weights); the step timed (CUDA events, from step 2), K1
    counted (once per step). A loss that
    turns non-finite is held to the CPU: on the forward of the step that
    broke (that one, or the one before where its gradient was not
    finite), the head's loss or gradient must not be finite on the CPU
    either (a head that overflows in fp32, as in JAX); the run stops
    there for that head, and the loss must have fallen before it where
    two steps ran. A loss that more than doubles in its first step
    diverges (heads that diverge on this stack at the yaml's rate, as in
    JAX: MP's unnormalized queries, CircleLoss on raw embeddings; the
    loss zoo's CPU tests show it in JAX): it is not held to fall, but to
    the CPU's first step from the same state. The CPU's loss must more
    than double too; the card's loss at step 0 must be within
    ``L2_DIVERGE_STEP0_REL`` of the CPU's (on the same weights these heads
    exponentiate the trunk's card-vs-CPU rounding: CircleLoss's logits are
    gamma * sim^2 of raw embeddings; measured 1.1e-3 for MP, 2.2e-2 for
    CircleLoss); and the card's loss after the first step within a factor
    ``L2_DIVERGE_AFTER_FACTOR`` of the CPU's (measured 1.38 and 3.03:
    AdaBelief's first step moves every weight by about +-lr, so gradients
    that differ a little move the weights apart; a card step that did not
    move the weights would leave its loss 4.6 and 37 times below the
    CPU's)."""
    import torch
    from speakerverification_tpu_torch.builder import optimizer_from_hparams
    counts = dict.fromkeys(KERNELS, 0)
    out, cpu_rise = {}, {}
    for name in L_HEADS:
        state, step = l_reset(model, trunk, l_head(name, h),
                              optimizer_from_hparams(h))
        losses, ms, overflow, snaps = [], [], None, []
        reset_counts()
        for i in range(L2_STEPS):
            snaps = snaps[-1:] + [{k: v.detach().clone()
                                   for k, v in model.state_dict().items()}]
            if i == 0:
                start = snaps[0]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, m = step(state, wave, label, h["lr"])
            ev[1].record()
            torch.cuda.synchronize()
            loss = float(m["loss"])
            ms.append(ev[0].elapsed_time(ev[1]))
            if not _finite(loss):
                # the step that broke: this one, or the one before if its
                # gradient already was not finite (then this step began
                # from non-finite weights)
                at = i if all(bool(torch.isfinite(v).all()) for v in
                              snaps[-1].values()
                              if v.is_floating_point()) else i - 1
                c = read_counts()
                broke = l_head_breaks(model, snaps[at - i - 1], wave, label)
                if broke != (True, True):
                    fail(f"path L2 {name}: loss {loss} at step {i}; the head "
                         f"on step {at}'s forward breaks on (card, CPU) "
                         f"{broke}")
                overflow = at
                break
            losses.append(loss)
        if overflow is None:
            c = read_counts()
        for k, v in read_counts().items():    # the check's forward too
            counts[k] += v
        n_steps = len(ms)
        # the mean of the last three (of up to ten) against step 0's
        # loss: the adaptive heads' loss swings by an order of magnitude
        # from step to step, and a mined head's is 0 at a step that mines
        # no pair (MultiSimilarity_v2 averages over the rows with a mined
        # pair, so its other steps stay near 0.4: a 0 among the first
        # three can put their mean below the last three's)
        k = min(3, len(losses) // 2)
        falls = k > 0 and sum(losses[-k:]) / k < losses[0]
        row = {"losses": [round(x, 5) for x in losses],
               "ms_per_step": sum(ms[1:]) / max(len(ms) - 1, 1),
               "k1_launches": c["mel_frontend"], "steps": n_steps}
        # a first step that more than doubles the loss is a divergence,
        # held to the CPU's first step from the same state (once per
        # head class: MP_Balance is MP)
        rises_on_cpu = False
        if overflow is None and losses[1] > 2 * losses[0]:
            cls = type(model.loss)
            if cls not in cpu_rise:
                cpu_rise[cls] = l_cpu_first_two(h, model, start, wave,
                                                label)
            cpu0, cpu1 = cpu_rise[cls]
            row["cpu_first_two"] = [cpu0, cpu1]
            row["step0_rel"] = abs(losses[0] - cpu0) / abs(cpu0)
            row["after_ratio"] = losses[1] / cpu1
            rises_on_cpu = (
                cpu1 > 2 * cpu0 and row["step0_rel"] <= L2_DIVERGE_STEP0_REL
                and 1 / L2_DIVERGE_AFTER_FACTOR <= row["after_ratio"]
                <= L2_DIVERGE_AFTER_FACTOR)
            falls = False
        ok = c["mel_frontend"] == n_steps and (falls or rises_on_cpu or (
            overflow is not None and overflow < 2))
        if overflow is not None:
            row["head_breaks_at_step"] = overflow
        out[name] = row
        log(f"[L2 {name}] " + json.dumps(row)
            + (" (the head's loss or gradient not finite there on the "
               "CPU too)" if overflow is not None else "")
            + (" (diverges: the first step more than doubles the loss, "
               "on the CPU too, within the bars of the CPU's)"
               if rises_on_cpu else "") + (" ok" if ok else " FAIL") + f" ({card})")
        if not ok:
            fail(f"path L2 {name}: the loss did not fall or K1 was not "
                 f"launched once per step ({row})")
    return {"counts": counts, "heads": out}


def l_grads(model, trunk, h: dict) -> list:
    """Three gradient trees of the default stack (ARmSoftmax) from full-
    width backward passes at its initial state, 32 x 2 crops each."""
    import torch
    from speakerverification_tpu_torch.optim import build_optimizer
    state, _ = l_reset(model, trunk, l_head("ARmSoftmax", h),
                       build_optimizer("sgd", h["lr"]))
    grads = []
    for i in range(3):
        wave, label = seeded_batch(90 + i, 32, 2, h)
        grads.append({k: g.detach() for k, g in loss_grads(
            state, torch.from_numpy(wave).to(E_DEVICE),
            torch.from_numpy(label).to(E_DEVICE)).items()})
    return state, grads


def l_updates(tx, params: dict, grads: list, n: int, keys=None,
              timed: bool = False):
    """``n`` updates of ``tx`` from ``params`` (copied) with ``grads``,
    over ``keys`` only where given; the final params and, ``timed``,
    each update's device ms (CUDA events)."""
    import torch
    from speakerverification_tpu_torch.optim import apply_updates
    keys = list(params) if keys is None else keys
    p = {k: params[k].detach().clone() for k in keys}
    s = tx.init(p)
    ms = []
    for i in range(n):
        g = {k: grads[i][k] for k in keys}
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        u, s = tx.update(g, s, p)
        apply_updates(p, u)
        if timed:
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
    return p, ms


def shampoo_cut(tree: dict, n_classes: int, keep: int) -> dict:
    """``tree``'s leaves with every axis of ``n_classes`` (the head's
    class axis) cut to its first ``keep`` entries."""
    out = {}
    for k, v in tree.items():
        for axis, size in enumerate(v.shape):
            if size == n_classes:
                v = v.narrow(axis, 0, keep)
        out[k] = v.contiguous()
    return out


def path_l3(h: dict, model, trunk, card: str, shampoo_classes=None,
            shampoo_cpu_axis: int = L_SHAMPOO_CPU_AXIS) -> dict:
    """Each new optimizer (and Lookahead over AdaBelief): three updates on
    the card and on the CPU from the same parameters with the same three
    gradient trees, every leaf within 1e-6 of its largest value (the CPU
    tests' bar) but those whose gradient is zero by construction
    (``ZERO_GRAD``: rounding noise, which Adafactor's relative step
    scales up to a full step; 1e-5 there). Shampoo: one update, on the
    CPU over the leaves whose axes are all <= ``shampoo_cpu_axis`` (in
    a thread, beside the card's); a leaf within 1e-5, or else no more
    than twice as far as the CPU's from a float64 run of that leaf (on the
    card): where a preconditioner is rank-deficient (a 1-D leaf, a Dense
    weight's gradient of rank <= 64) its inverse root scales fp32
    rounding by up to eps^(-1/order). Then ``L3_STEPS`` train steps on the card
    (none for Shampoo: one update takes ~38 s, almost all one SVD of the
    13,103² class-axis preconditioner), the loss and the parameters
    finite, the step and ``tx.update`` timed (CUDA events). With
    ``shampoo_classes``, Shampoo's update runs on the head's first that
    many classes (its leaves are updated each on its own)."""
    import concurrent.futures

    import torch
    from speakerverification_tpu_torch.optim import build_optimizer
    from speakerverification_tpu_torch.optim import to_flax
    base, grads = l_grads(model, trunk, h)
    params = {k: p.detach().clone() for k, p in base.params.items()}
    params_cpu = {k: p.cpu() for k, p in params.items()}
    grads_cpu = [{k: g.cpu() for k, g in gr.items()} for gr in grads]
    wave, label = seeded_batch(95, 32, 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    label = torch.from_numpy(label).to(E_DEVICE)
    counts = dict.fromkeys(KERNELS, 0)
    out = {}
    wd = float(h["optimizer"].get("weight_decay", 0.0))
    for name, kw in L_OPTIMIZERS:
        label_name = name + ("" if not kw.get("inner") else
                             f" over {kw['inner']}")
        tx = build_optimizer(name, h["lr"], weight_decay=wd, **kw)
        t0 = time.time()
        p64 = None
        bar = 1e-5 if name == "Shampoo" else 1e-6
        if name == "Shampoo":
            n = 1
            s_params, s_params_cpu, s_grads, s_grads_cpu = \
                params, params_cpu, grads, grads_cpu
            if shampoo_classes:
                def cut(tree):
                    return shampoo_cut(tree, int(h["nClasses"]),
                                       shampoo_classes)
                s_params, s_params_cpu = cut(params), cut(params_cpu)
                s_grads = [cut(g) for g in grads]
                s_grads_cpu = [cut(g) for g in grads_cpu]
            keys = [k for k in s_params if max(to_flax(
                k, s_params[k]).shape, default=0) <= shampoo_cpu_axis]
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                cpu_job = pool.submit(l_updates, tx, s_params_cpu,
                                      s_grads_cpu, n, keys)
                p_card, upd_ms = l_updates(tx, s_params, s_grads, n,
                                           timed=True)
                t1 = time.time()
                p_cpu, _ = cpu_job.result()
            # the float64 run, of the leaves that miss the bar only (each
            # leaf's update is its own)
            miss = [k for k in keys if float(
                (p_card[k].cpu() - p_cpu[k]).abs().max()) > bar * max(
                float(p_cpu[k].abs().max()), 1e-30)]
            p64, _ = l_updates(tx, {k: s_params[k].double() for k in miss},
                               [{k: g[k].double() for k in miss}
                                for g in s_grads], n)
        else:
            n = L3_UPDATES
            p_card, upd_ms = l_updates(tx, params, grads, n, timed=True)
            t1 = time.time()
            p_cpu, _ = l_updates(tx, params_cpu, grads_cpu, n)
        t2 = time.time()
        worst, worst_at, zero_worst, refereed = 0.0, "", 0.0, []
        for k, ref in p_cpu.items():
            got = p_card[k].cpu()
            scale = max(float(ref.abs().max()), 1e-30)
            err = float((got - ref).abs().max()) / scale
            if p64 is not None and err > bar:
                r64 = p64[k].cpu()
                d_card = float((got.double() - r64).abs().max())
                d_cpu = float((ref.double() - r64).abs().max())
                refereed.append((d_card / max(d_cpu, 1e-300), err, k))
                if d_card <= 2 * d_cpu:
                    continue
            if k.endswith(ZERO_GRAD) and p64 is None:
                zero_worst = max(zero_worst, err)
            elif err > worst:
                worst, worst_at = err, k
        # L3_STEPS train steps on the card (Shampoo runs its one update
        # only)
        state, step = l_reset(model, trunk, l_head("ARmSoftmax", h), tx)
        reset_counts()
        steps = 0 if name == "Shampoo" else L3_STEPS
        ms, losses = [], []
        for i in range(steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, m = step(state, wave, label, h["lr"])
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
        c = read_counts()
        for k in KERNELS:
            counts[k] += c[k]
        update_ms = sum(upd_ms[1:]) / (len(upd_ms) - 1) \
            if len(upd_ms) > 1 else upd_ms[0]     # the first picks plans
        step_ms = sum(ms[1:]) / (len(ms) - 1) if ms else None
        finite = all(_finite(x) for x in losses) and all(
            bool(torch.isfinite(p).all()) for p in p_card.values())
        ok = (worst <= bar and zero_worst <= 1e-5 and finite
              and c["mel_frontend"] == steps)
        row = {"updates": n, "leaves_compared": len(p_cpu),
               "max_rel_err": worst, "bar": bar, "at": worst_at,
               "zero_grad_max_rel_err": zero_worst,
               "update_ms": update_ms, "step_ms": step_ms,
               "update_share": update_ms / step_ms if ms else None,
               "losses": [round(x, 5) for x in losses],
               "wall_s": {"card_updates": round(t1 - t0, 1),
                          "cpu_and_referee": round(t2 - t1, 1),
                          "steps": round(time.time() - t2, 1)}}
        if p64 is not None:
            row["refereed_leaves"] = len(refereed)
            row["refereed_max_ratio"] = max((r[0] for r in refereed),
                                            default=0.0)
            for ratio, err, k in sorted(refereed, reverse=True)[:5]:
                log(f"[L3 {label_name} leaf] {k}: card vs CPU {err:.3e} of "
                    f"its largest; from float64 the card is {ratio:.3f}x as "
                    "far as the CPU")
        out[label_name] = row
        log(f"[L3 {label_name}] " + json.dumps(row) + (" ok" if ok else
                                                       " FAIL") + f" ({card})")
        if not ok:
            fail(f"path L3 {label_name}: card and CPU disagree, or the "
                 f"loss is not finite ({row})")
    return {"counts": counts, "optimizers": out}


def path_l4(h: dict, model, trunk, card: str) -> dict:
    """One step of ``make_adahessian_loss_update`` (gradients and the
    Hutchinson trace by double backward) over the default stack at 32 x 2
    crops, against the plain Adahessian step (``|grad|`` for the
    curvature): time (CUDA events), peak memory, a finite loss."""
    import torch
    from torch.func import functional_call
    from speakerverification_tpu_torch.optim import build_optimizer
    from speakerverification_tpu_torch.optim.second_order import (
        make_adahessian_loss_update,
    )
    from speakerverification_tpu_torch.training.train_step import (
        timed_conv_plans,
    )
    tx = build_optimizer("Adahessian", h["lr"])
    wave, label = seeded_batch(96, 32, 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    label = torch.from_numpy(label).to(E_DEVICE)
    out = {}
    reset_counts()
    for kind in ("plain", "true"):
        state, step = l_reset(model, trunk, l_head("ARmSoftmax", h), tx)
        buffers = dict(model.named_buffers())

        def loss_fn(p):
            loss, _ = functional_call(model, {**p, **buffers},
                                      (wave, label))
            return loss.float()

        true_step = make_adahessian_loss_update(loss_fn, tx)
        gen = torch.Generator(device=E_DEVICE).manual_seed(0)
        box = {"state": state}

        def one():
            if kind == "plain":
                box["state"], m = step(box["state"], wave, label, h["lr"])
                return float(m["loss"])
            st = box["state"]
            with timed_conv_plans(wave.device):
                new, st.opt_state, loss = true_step(st.params, st.opt_state,
                                                    gen)
            with torch.no_grad():
                for k, p in st.params.items():
                    p.copy_(new[k])
            return float(loss)
        model.train()
        one()                       # the first call picks cuDNN's plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = one()
        ev[1].record()
        torch.cuda.synchronize()
        out[kind] = {"ms": ev[0].elapsed_time(ev[1]),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "loss": loss}
        if not (loss == loss and abs(loss) != float("inf")):
            fail(f"path L4 {kind}: loss not finite ({loss})")
    counts = read_counts()
    log(f"[L4] Adahessian at 32 x 2 crops, the plain step (|grad|) "
        f"{out['plain']['ms']:.2f} ms, {out['plain']['peak_gib']:.2f} GiB; "
        f"the true second-order step (double backward) "
        f"{out['true']['ms']:.2f} ms, {out['true']['peak_gib']:.2f} GiB; "
        f"losses {out['plain']['loss']:.4f}, {out['true']['loss']:.4f}; "
        f"launches {counts} ({card})")
    if counts["mel_frontend"] != 4:
        fail(f"path L4: K1 launched {counts['mel_frontend']} times in 4 steps")
    return {"counts": counts, **out}


def path_l5(tmp, h: dict, card: str) -> dict:
    """``--do_train`` (one epoch) with a summed zoo head and Lamb through
    the CLI, then its ``last_state`` read back into a fresh train state:
    the optimizer state written again equals the file's leaf for leaf;
    then ``--do_infer --eval`` (path E4's checks). The head is
    MSAmSoftmax (``ARmSoftmax_0`` by flax's auto-name): MMP_Balance_MTL's
    epoch loss is NaN on this stack (its MMP term overflows fp32 at the
    embedding norms of 16-72, ROADMAP C.13, as in JAX), so its run keeps
    no best checkpoint to evaluate."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch import checkpoint as codec
    from speakerverification_tpu_torch.training import checkpoint as tckpt
    head = "MSAmSoftmax"
    hl = {**h, "criterion": {"name": head},
          "optimizer": {**h["optimizer"], "name": "Lamb"}}
    e = path_e4(tmp, card, hl, tag="L5", epochs=1)
    path = (tmp / "save" / hl["model"]["name"] / head / "model"
            / "last_state.msgpack")
    raw = codec.load_checkpoint(path)
    # the trainer sizes the head by the manifest's speakers
    n_classes = int(np.asarray(raw["params"]["loss"]["ARmSoftmax_0"]["W"])
                    .shape[1])
    fresh, _ = train_state({**hl, "nClasses": n_classes}, E_DEVICE)
    tckpt.load_checkpoint(path, fresh)
    again = codec._state_dict(tckpt.state_to_jax(fresh)["opt_state"])

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(leaves(v, f"{prefix}/{k}"))
            return out
        return {prefix: np.asarray(tree.float() if isinstance(
            tree, torch.Tensor) and tree.dtype == torch.bfloat16 else tree)}
    want, got = leaves(raw["opt_state"]), leaves(again)
    same = set(want) == set(got) and all(
        want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])
        for k in want)
    count = int(np.asarray(raw["opt_state"]["inner_state"]["count"]))
    log(f"[L5] last_state read back into a fresh state: {len(want)} "
        f"optimizer-state leaves, Lamb's count {count} (steps {e['steps']}), "
        f"written again {'equal' if same else 'DIFFERENT'}")
    if not same or fresh.step != e["steps"] or count != e["steps"]:
        fail("path L5: the optimizer state read back differs from the "
             "checkpoint's")
    return e


def path_l(tmp, card: str, h: dict = RAW3_TRAIN_HPARAMS,
           shampoo_classes=None,
           shampoo_cpu_axis: int = L_SHAMPOO_CPU_AXIS) -> dict:
    """The eleventh slice (L1-L5) on the default stack at path E's width:
    the 17 new heads against the CPU (L1) and in the train step (L2), the
    24 new optimizers and Lookahead over AdaBelief against the CPU and in
    the step (L3; Shampoo on ``shampoo_classes`` of the head's classes
    when set, against the CPU over the leaves with every axis <=
    ``shampoo_cpu_axis``), Adahessian's true second-order step (L4), the CLI with
    MSAmSoftmax and Lamb (L5)."""
    import torch
    walls = {}

    def timed_phase(phase, fn, *args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        walls[phase] = round(time.time() - t0, 1)
        return out

    model, trunk = timed_phase("setup", l_stack, h)
    wave, label = seeded_batch(88, 32, 2, h)
    wave = torch.from_numpy(wave).to(E_DEVICE)
    label = torch.from_numpy(label).to(E_DEVICE)
    l1 = timed_phase("L1", path_l1, h, model, wave, label)
    l2 = timed_phase("L2", path_l2, h, model, trunk, wave, label, card)
    l4 = timed_phase("L4", path_l4, h, model, trunk, card)
    l5 = timed_phase("L5", path_l5, tmp, h, card)
    # last: Shampoo's one update holds ~4 GiB of 13,103² matrices
    l3 = timed_phase("L3", path_l3, h, model, trunk, card,
                     shampoo_classes, shampoo_cpu_axis)
    counts = {k: l1["counts"][k] + l2["counts"][k] + l3["counts"][k]
              + l4["counts"][k] + l5["counts"][k] for k in KERNELS}
    log(f"[L] launches over L1-L5: {counts}; wall by phase (s) {walls}, "
        f"{sum(walls.values()):.1f} s in all")
    if counts["res2net_cascade"] or counts["quant_matmul"]:
        fail(f"path L: unexpected launches {counts}")
    return {"counts": counts, "l1": l1, "l2": l2, "l3": l3, "l4": l4}


# ----------------------------------------------------------------------
# path M: the rest of the model zoo
# ----------------------------------------------------------------------
# M1/M2: each model at its builder's defaults with ecapa_tdnn.yaml's audio
# keys (16 kHz, 2 s crops, 80 mels, fmin 20, fmax 7600), 8 x 20 crops a
# served batch; the raw-wave models take features: raw
M_IMAGE = {"EfficientNet": 512, "EfficientNetv2": 512, "RepVGG": 256,
           "SCnet": 256, "DPN": 512}
M_RAW = {"RawNeXt": 512, "ResNeXt": 512, "RawNet3": 512}
# M2: RawNet3's other settings, each option in one of these, on 32 crops
M_RAWNET3_OPTIONS = [
    {"out_bn": True, "encoder_type": "ECA"},
    {"log_sinc": False, "norm_sinc": "mean_std"},
    {"norm_sinc": "none", "summed": False},
    {"context": False, "sinc_stride": 5},
]
# M3: raw3_ecapa.yaml's keys (8 kHz) with a list-valued name
MIXED_HPARAMS = {
    **RAW3_ECAPA_HPARAMS,
    "model": {"name": ["RawNet3", "ECAPA_TDNN"], "feature_type": "raw",
              "nOut": 512, "nOuts": [320, 192], "conv_backend": "pallas"},
}
# K3 in each model's int8 forward at the serving batch (160 crops): x as
# the wrapper gets it, N, launches per forward, the model
# (tests/test_torch_port_mixed.py holds them against the models)
M_QUANT_SHAPES = [
    ((160, 3584), 512, 1, "EfficientNet"),
    ((160, 1792), 512, 1, "EfficientNetv2"),
    ((160, 2560), 320, 1, "RepVGG"), ((160, 2560), 256, 1, "RepVGG"),
    ((160, 2048), 256, 1, "SCnet"),
    ((160, 2688), 512, 1, "DPN"),
    ((160, 512, 2187), 256, 1, "RawNeXt"), ((160, 512, 729), 256, 1, "RawNeXt"),
    ((160, 1024, 729), 256, 1, "RawNeXt"), ((160, 512, 3), 170, 6, "RawNeXt"),
    ((160, 512, 243), 256, 3, "RawNeXt"), ((160, 512, 81), 128, 3, "RawNeXt"),
    ((160, 512, 729), 128, 3, "RawNeXt"), ((160, 1024, 243), 512, 1, "RawNeXt"),
    ((160, 1792, 243), 512, 1, "RawNeXt"), ((160, 512, 81), 256, 2, "RawNeXt"),
    ((160, 512, 27), 128, 2, "RawNeXt"), ((160, 512, 243), 128, 2, "RawNeXt"),
    ((160, 1536, 81), 512, 1, "RawNeXt"), ((160, 1024), 512, 1, "RawNeXt"),
    ((160, 512, 3), 170, 3, "ResNeXt"), ((160, 512, 243), 256, 1, "ResNeXt"),
    ((160, 512, 81), 128, 1, "ResNeXt"), ((160, 512, 729), 128, 1, "ResNeXt"),
    ((160, 512, 81), 256, 1, "ResNeXt"), ((160, 512, 27), 128, 1, "ResNeXt"),
    ((160, 512, 243), 128, 1, "ResNeXt"), ((160, 1024), 512, 1, "ResNeXt"),
    ((160, 1024, 3175), 1024, 1, "RawNet3"), ((160, 1024), 1024, 3, "RawNet3"),
    ((160, 1024, 635), 1024, 2, "RawNet3"),
    ((160, 1024, 211), 1024, 2, "RawNet3"),
    ((160, 3072, 211), 1536, 1, "RawNet3"),
    ((160, 4608, 211), 128, 1, "RawNet3"), ((160, 3072), 512, 1, "RawNet3"),
    ((160, 1024, 1575), 1024, 1, "Mixed"), ((160, 1024), 1024, 3, "Mixed"),
    ((160, 1024, 315), 1024, 2, "Mixed"), ((160, 1024, 105), 1024, 2, "Mixed"),
    ((160, 3072, 105), 1536, 1, "Mixed"), ((160, 4608, 105), 128, 1, "Mixed"),
    ((160, 3072), 320, 1, "Mixed"), ((160, 1024, 201), 1024, 6, "Mixed"),
    ((160, 1024, 1), 128, 3, "Mixed"), ((160, 3072, 201), 3072, 1, "Mixed"),
    ((160, 6144), 192, 1, "Mixed"),
]
# M5: gradients zero by construction (a bias before a train-mode BN, or
# one that shifts every slot or step of a softmax alike: the gates' and
# the pooling's), and the bar of the gradient check by module: RawNeXt's
# stem sits at cosine 0.99969 card vs CPU (an H100 80GB, 4 x 2 crops), its
# gradient passed back through 20-odd train-mode BatchNorms in fp32
M_ZERO_GRAD = {
    "EfficientNet": (),
    "RawNeXt": ("GateModule_0.Conv_1.bias", "GateModule_0.BatchNorm_0.bias",
                "backbone.Conv_4.bias", "backbone.BatchNorm_3.bias",
                "backbone.BatchNorm_4.bias", "backbone.Dense_0.bias",
                "ConvTranspose_1.bias"),
}
M_GRAD_BAR = {"EfficientNet": 0.999, "RawNeXt": 0.998}


def m_hparams(name: str, n_out: int) -> dict:
    """ecapa_tdnn.yaml's keys (path J's, with its train keys) for one
    model of path M at its builder's nOut."""
    ft = "raw" if name in M_RAW else "melspectrogram"
    return {**RESNETSE_HPARAMS, "features": ft,
            "model": {"name": name, "feature_type": ft, "nOut": n_out}}


def m_quant_table(model: str) -> list:
    return [r for r in M_QUANT_SHAPES if r[3] == model]


def m_waves(h: dict, n: int, seed: int):
    import numpy as np
    return (0.1 * np.random.default_rng(seed).normal(
        0, 1, (n, crop_samples(h)))).astype(np.float32)


def m_served(tag: str, h: dict, seed: int, card: str, want: dict) -> dict:
    """One served batch (8 x ``num_eval`` crops) of ``h``'s model through
    ``InferenceEngine`` on the card: launches (``want`` per forward),
    forward ms, peak memory, 16 crops against the CPU's plain path."""
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    engine = InferenceEngine(h, device=E_DEVICE)
    randomize_bn_(engine.model, seed=seed)
    n_params = sum(p.numel() for p in engine.model.parameters())
    waves = m_waves(h, BATCH_UTTS * h["num_eval"], seed)
    engine.embed_fn(waves)                               # warm-up
    torch.cuda.synchronize()
    reset_counts()
    peak = peak_gib(lambda: engine.embed_fn(waves))
    got = read_counts()
    name = h["model"]["name"]
    name = "+".join(name) if isinstance(name, list) else name
    log(f"[{tag}] {name}: {n_params / 1e6:.2f} M params; a served batch "
        f"of {len(waves)} crops: peak memory {peak:.2f} GiB, launches "
        f"{got} ({card})")
    if got != want:
        fail(f"path {tag} {name}: expected {want}, got {got}")
    throughput(f"{tag} {name}", engine, waves, h["num_eval"], card)
    compare_with_cpu(engine, waves[:16], f"{tag} {name}")
    float_emb = engine.embed_fn(waves).cpu().numpy()
    return {"engine": engine, "waves": waves, "counts": got, "peak": peak,
            "params": n_params, "float_emb": float_emb}


def m_fold_repvgg(served: dict) -> None:
    """RepVGG's deploy fold on the card: the folded model's embeddings
    against the train layout's, in eval."""
    import copy

    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import make_eval_embed_fn
    from speakerverification_tpu_torch.models.image_encoders import (
        repvgg_reparameterize,
    )
    from speakerverification_tpu_torch.registry import MODELS
    engine = served["engine"]
    deploy = copy.deepcopy(engine.model)
    deploy.backbone = MODELS.get("RepVGG")(nOut=256, deploy=True).to(
        E_DEVICE)
    deploy.backbone.load_state_dict(repvgg_reparameterize(
        engine.model.backbone.state_dict()), strict=True)
    got = make_eval_embed_fn(deploy)(served["waves"]).cpu().numpy()
    want = served["float_emb"]
    cos = cosines(got, want)
    err = float(np.abs(got - want).max())
    ok = bool(np.isfinite(got).all()) and cos.min() >= 0.99999
    log(f"[M1 RepVGG deploy fold] {sum(1 for k in deploy.backbone.state_dict() if k.endswith('rbr_reparam.weight'))} "
        f"blocks folded; embeddings vs the train layout on the card, "
        f"{len(got)} crops: min cos {cos.min():.8f} (need >= 0.99999), "
        f"max abs diff {err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path M1: RepVGG's deploy fold changes the embeddings")
    del deploy
    torch.cuda.empty_cache()


def path_m1(card: str) -> dict:
    """The five mel-image encoders at their builders' defaults, one
    served batch each (K1 once per forward), RepVGG's deploy fold."""
    counts = dict.fromkeys(KERNELS, 0)
    out = {}
    for i, (name, n_out) in enumerate(M_IMAGE.items()):
        served = m_served("M1", m_hparams(name, n_out), 80 + i, card,
                          {"mel_frontend": 1, "res2net_cascade": 0,
                           "quant_matmul": 0})
        if name == "RepVGG":
            m_fold_repvgg(served)
        for k, v in served["counts"].items():
            counts[k] += v
        out[name] = {k: served[k] for k in ("waves", "float_emb", "peak",
                                            "params")}
        del served
    return {"counts": counts, "models": out}


def path_m2(card: str) -> dict:
    """RawNeXt, ResNeXt and RawNet3 at their defaults, one served batch
    each (no kernel: they take the wave); RawNet3's other options on 32
    crops each against the CPU."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    counts = dict.fromkeys(KERNELS, 0)
    none = dict.fromkeys(KERNELS, 0)
    out = {}
    for i, (name, n_out) in enumerate(M_RAW.items()):
        served = m_served("M2", m_hparams(name, n_out), 90 + i, card, none)
        out[name] = {k: served[k] for k in ("waves", "float_emb", "peak",
                                            "params")}
        del served
    for i, opts in enumerate(M_RAWNET3_OPTIONS):
        h = m_hparams("RawNet3", 512)
        h = {**h, "model": {**h["model"], **opts}}
        engine = InferenceEngine(h, device=E_DEVICE)
        randomize_bn_(engine.model, seed=95 + i)
        waves = m_waves(h, 32, 95 + i)
        reset_counts()
        compare_with_cpu(engine, waves, f"M2 RawNet3 {opts}")
        if read_counts() != none:
            fail(f"path M2 RawNet3 {opts}: launched {read_counts()}")
        del engine
    torch.cuda.empty_cache()
    return {"counts": counts, "models": out}


def path_m3(dev, gen, card: str) -> dict:
    """Mixed RawNet3 + ECAPA_TDNN (raw3_ecapa.yaml's keys, conv_backend
    pallas): one served batch (K1 once, K2 three times per forward)
    against the CPU; K2 at the ECAPA branch's shape."""
    served = m_served("M3", MIXED_HPARAMS, 100, card,
                      {"mel_frontend": 1, "res2net_cascade": 3,
                       "quant_matmul": 0})
    k2 = check_cascade_kernel(dev, gen, shapes=((128, 160),),
                              time_every=True)
    out = {k: served[k] for k in ("waves", "float_emb", "peak", "params",
                                  "counts")}
    return {**out, "k2": k2}


def path_m4(m1: dict, m2: dict, m3: dict, dev, gen, card: str) -> dict:
    """``quant: int8`` of every path-M model (each has a layer over JAX's
    floors: its table), served against the plain int8 path on the CPU
    and the float path; then K3 at every new shape, fp32 and bf16."""
    import torch
    counts = dict.fromkeys(KERNELS, 0)
    cases = [(name, m_hparams(name, n), m1["models"][name], 80 + i, 1, 0)
             for i, (name, n) in enumerate(M_IMAGE.items())]
    cases += [(name, m_hparams(name, n), m2["models"][name], 90 + i, 0, 0)
              for i, (name, n) in enumerate(M_RAW.items())]
    cases.append(("Mixed", MIXED_HPARAMS, m3, 100, 1, 3))
    empty = [name for name, *_ in cases if not m_quant_table(name)]
    log(f"[M4] models with no layer over JAX's floors (K >= 512, N >= "
        f"128): {empty or 'none'}")
    for name, h, served, seed, mel, cascade in cases:
        table = m_quant_table(name)
        log(f"[M4 {name} int8 table] " + "; ".join(
            f"{quant_label(s, n, torch.float32)[:-8]} x{c}"
            for s, n, c, _ in table))
        got = int8_served("M4", h, served["waves"], served["float_emb"],
                          table, seed, card, mel=mel, cascade=cascade)
        for k, v in got.items():
            counts[k] += v
    seen = {(s, n) for s, n, _, _ in QUANT_SHAPES + ZOO_QUANT_SHAPES}
    new = []
    for s, n, c, model in M_QUANT_SHAPES:
        if (s, n) not in seen:
            seen.add((s, n))
            new.append((s, n, c, model))
    rows = [check_quant_shape(dev, gen, s, n, dtype, c, model,
                              detail=False)
            for s, n, c, model in new
            for dtype in (torch.float32, torch.bfloat16)]
    for dt in ("float32", "bfloat16"):
        mine = [r for r in rows if r["shape"].endswith(dt)]

        def total(key):
            return sum((r[key] or 0.0) * r["launches_per_forward"]
                       for r in mine)
        log(f"[M4 new shapes per forward {dt}] {len(mine)} shapes: K3 "
            f"{total('ms'):.3f} ms, bound {total('bound_ms'):.3f} ms, "
            f"_int_mm chain {total('library_ms'):.3f} ms, float layers "
            f"{total('float_ms'):.3f} ms, plain {total('plain_ms'):.3f} ms")
    return {"counts": counts, "k3": rows}


def path_m5(card: str) -> dict:
    """The 64 x 2-crop AAmSoftmax (5,994) + AdaBelief step of
    EfficientNet-b4 and RawNeXt: the gradient by module on the card
    against the CPU from one state (4 speakers x 2 crops, dropout off),
    then the fp32 step timed with EfficientNet's dropout drawn on the
    card."""
    import torch
    counts = dict.fromkeys(KERNELS, 0)
    out = {}
    for name in ("EfficientNet", "RawNeXt"):
        h = m_hparams(name, 512)
        cpu, _ = train_state(h, "cpu")
        card_state, _ = train_state(h, E_DEVICE)
        for st in (cpu, card_state):
            dropout_off(st.model)
        copy_state(cpu, card_state)
        wave, label = seeded_batch(110, 4, 2, h)
        reset_counts()
        g_card = loss_grads(card_state, torch.from_numpy(wave).to(E_DEVICE),
                            torch.from_numpy(label).to(E_DEVICE))
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            counts[k] += v
        g_cpu = loss_grads(cpu, torch.from_numpy(wave),
                           torch.from_numpy(label))
        grad = module_cosines(g_card, g_cpu, _zoo_module, M_ZERO_GRAD[name])
        low = min(v["cos"] for v in grad.values())
        bar = M_GRAD_BAR[name]
        ok = low >= bar
        log(f"[M5 {name} gradient] card vs CPU at the initial state, dropout"
            f" off, {len(grad)} modules, lowest cos {low:.7f} (bar {bar}): "
            + json.dumps(grad) + (" ok" if ok else " FAIL"))
        if not ok:
            fail(f"path M5 {name}: the card's gradient disagrees with the "
                 "CPU's")
        del cpu, card_state
        gen = torch.Generator(device=E_DEVICE)
        gen.manual_seed(7)
        reset_counts()
        fp32 = time_steps(f"{name} fp32", h, card, tag="M5",
                          step_args=(gen,))
        timed = read_counts()
        want_mel = fp32["steps"] if name in M_IMAGE else 0
        if timed["mel_frontend"] != want_mel:
            fail(f"path M5 {name}: K1 launched {timed['mel_frontend']} "
                 f"times in {fp32['steps']} steps")
        for k, v in timed.items():
            counts[k] += v
        out[name] = fp32
        torch.cuda.empty_cache()
    return {"counts": counts, **out}


def path_m6(card: str) -> None:
    """TDFbanks (both modes) and the eight pooling modules: one forward
    each on the card against the CPU."""
    import copy

    import numpy as np
    import torch
    from speakerverification_tpu_torch.models import pooling_extra as P
    from speakerverification_tpu_torch.models.tdfbanks import TDFbanks
    from speakerverification_tpu_torch.weights import init_weights_
    rng = np.random.default_rng(120)
    waves = torch.from_numpy((0.1 * rng.normal(0, 1, (160, 32000))).astype(
        np.float32))
    feats = torch.from_numpy(rng.normal(0, 1, (160, 201, 192)).astype(
        np.float32))
    modules = [
        ("TDFbanks learnfbanks", TDFbanks(), waves, 1e-4),
        ("TDFbanks Fixed mvn", TDFbanks(mode="Fixed", mvn=True), waves, 1e-4),
        ("AttentionPooling", P.AttentionPooling(192), feats, 1e-5),
        ("MultiHeadAttentionPooling", P.MultiHeadAttentionPooling(192, 4),
         feats, 1e-5),
        ("DoubleMHA", P.DoubleMHA(192, 4), feats, 1e-5),
        ("TemporalPyramidPooling", P.TemporalPyramidPooling(), feats, 1e-5),
        ("GlobalAveragePooling", P.GlobalAveragePooling(), feats, 1e-5),
        ("SimpleSelfAttention", P.SimpleSelfAttention(192), feats, 1e-5),
        ("GraphAttentionLayer", P.GraphAttentionLayer(192, 128), feats, 1e-5),
        ("GraphPool", P.GraphPool(192), feats, 1e-5),
    ]
    for i, (name, mod, x, rel) in enumerate(modules):
        init_weights_(mod, torch.Generator().manual_seed(120 + i))
        mod.eval()
        with torch.no_grad():
            ref = mod(x[:16]).numpy()
            card_mod = copy.deepcopy(mod).to(E_DEVICE)
            out = card_mod(x.to(E_DEVICE))
            ms = cuda_ms(lambda: card_mod(x.to(E_DEVICE)), iters=5,
                         warmup=1)
            got = out[:16].cpu().numpy()
        err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))
        ok = bool(np.isfinite(out.cpu().numpy()).all()) and err <= rel
        log(f"[M6 {name}] {tuple(x.shape)} -> {tuple(out.shape)} on the "
            f"card in {ms:.3f} ms; 16 rows vs the CPU: rel err {err:.2e} "
            f"(bar {rel:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"path M6 {name}: the card disagrees with the CPU")


def path_m(dev, gen, card: str) -> dict:
    """The twelfth slice (M1-M6): the mel-image encoders served with
    RepVGG's fold (M1), RawNeXt, ResNeXt and RawNet3 with its options
    (M2), Mixed RawNet3 + ECAPA_TDNN with K2 (M3), int8 of every model
    with K3 at every new shape (M4), the EfficientNet-b4 and RawNeXt
    train steps (M5), TDFbanks and the pooling modules (M6)."""
    walls = {}

    def timed_phase(phase, fn, *args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        walls[phase] = round(time.time() - t0, 1)
        return out

    m1 = timed_phase("M1", path_m1, card)
    m2 = timed_phase("M2", path_m2, card)
    m3 = timed_phase("M3", path_m3, dev, gen, card)
    m4 = timed_phase("M4", path_m4, m1, m2, m3, dev, gen, card)
    m5 = timed_phase("M5", path_m5, card)
    timed_phase("M6", path_m6, card)
    counts = {k: m1["counts"][k] + m2["counts"][k] + m3["counts"][k]
              + m4["counts"][k] + m5["counts"][k] for k in KERNELS}
    log(f"[M] launches over M1-M6: {counts}; wall by phase (s) {walls}, "
        f"{sum(walls.values()):.1f} s in all")
    int8 = sum(r[2] for r in M_QUANT_SHAPES)
    if counts["quant_matmul"] != int8 or counts["res2net_cascade"] != 6 \
            or counts["mel_frontend"] < 1:
        fail(f"path M: unexpected launches {counts}")
    return {"counts": counts, "k3": m4["k3"], "k2": m3["k2"],
            "m5": {k: m5[k] for k in ("EfficientNet", "RawNeXt")}}


# ----------------------------------------------------------------------
# path N: export, the feature-domain ops and the tools
# ----------------------------------------------------------------------
# raw3_ecapa.yaml's serving keys with the cascade kernel on the hybrid's
# ECAPA branch, so that the exported program runs K1 once and K2 3 times
N_HPARAMS = {**RAW3_ECAPA_HPARAMS, "model": {
    **RAW3_ECAPA_HPARAMS["model"], "conv_backend": "pallas"}}
N_REPS = (3, 10)       # warm-up and timed forwards of each program
# a fresh process: load the exported program, replay, write the chrome
# trace of one profiled forward, time 10 forwards after 3; the seconds of
# its imports, of the load and of the first forward
N_LOAD = r"""
import json, sys, time
t0 = time.time()
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from speakerverification_tpu_torch.export import load_exported
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out_dir, x_path, emb_path, trace_path, warm, reps = sys.argv[1:7]
x = torch.from_numpy(np.load(x_path)).cuda()
t1 = time.time()
embed = load_exported(out_dir)
t2 = time.time()
emb = embed(x)
torch.cuda.synchronize()
t3 = time.time()
np.save(emb_path, emb.cpu().numpy())
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    embed(x)
    torch.cuda.synchronize()
p.export_chrome_trace(trace_path)
for _ in range(int(warm)):
    embed(x)
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
torch.cuda.synchronize()
start.record()
for _ in range(int(reps)):
    embed(x)
end.record()
torch.cuda.synchronize()
print(json.dumps({"ms": start.elapsed_time(end) / int(reps),
                  "import_s": t1 - t0, "load_s": t2 - t1,
                  "first_s": t3 - t2}))
"""


def trace_kernels(trace_path, tag: str) -> int:
    """The device kernels named ``tag`` in a chrome trace that
    ``torch.profiler`` wrote."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    return sum(tag in str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel")


def n_export_cli(tmp, tag: str, cfg: dict, args=(), path=None) -> tuple:
    """``--do_export`` of ``cfg`` (written to a config file unless ``path``
    names its file) through the CLI on the card: the export's seconds and
    its directory; the self-check runs inside."""
    import io
    from pathlib import Path

    import torch
    from speakerverification_tpu_torch.cli.main import main as cli_main
    if path is None:
        path = tmp / f"{tag}.yaml"
        path.write_text(json.dumps(cfg, indent=1))   # YAML's JSON subset
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--do_export", "--config", str(path), *args])
    torch.cuda.synchronize()
    secs = time.time() - t0
    for line in out.getvalue().splitlines():
        log(f"[{tag} cli] {line}")
    model = cfg["model"]["name"]
    crit = (cfg.get("criterion") or {}).get("name", "loss")
    out_dir = Path(cfg["save_folder"]) / model / crit / "model" / "export"
    files = sorted(p.name for p in out_dir.iterdir()) if out_dir.exists() \
        else []
    if rc != 0 or files != ["config.json", "model.pt2", "params.msgpack"] \
            or "[INFO] exported to" not in out.getvalue():
        fail(f"path {tag}: --do_export rc {rc}, wrote {files}")
    return secs, out_dir


def n_turns(live, program) -> tuple:
    """ms per forward of ``live`` and ``program`` (CUDA events, ``N_REPS``),
    in turns: live, program, program, live."""
    t = [cuda_ms(fn, iters=N_REPS[1], warmup=N_REPS[0])
         for fn in (live, program, program, live)]
    return ([round(t[0], 3), round(t[3], 3)],
            [round(t[1], 3), round(t[2], 3)])


def n_fresh_load(tmp, out_dir, x, tag: str) -> dict:
    """The exported program in a process of its own: embeddings, K1's
    and K2's kernels in the trace of one profiled forward, ms per
    forward and the seconds of each stage."""
    import os

    import numpy as np
    x_path, emb_path = tmp / f"{tag}_x.npy", tmp / f"{tag}_emb.npy"
    trace = tmp / f"{tag}_forward_trace.json"
    np.save(x_path, x)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", N_LOAD, str(out_dir), str(x_path),
         str(emb_path), str(trace), *map(str, N_REPS)], cwd=os.getcwd(),
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"path {tag}: loading the program in a fresh process failed:\n"
             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["emb"] = np.load(emb_path)
    res["k1"] = trace_kernels(trace, "mel_kernel")
    res["k2"] = trace_kernels(trace, "cascade_kernel")
    res["wall"] = time.time() - t0
    return res


def path_n1(tmp, card: str) -> dict:
    """N1: the default stack exported at full width through the CLI (seeded
    weights, random BN), the program against the live engine in a fresh
    process and here, its kernels counted, both timed; then
    ``raw3_ecapa.yaml`` itself exported as it stands."""
    import os

    import numpy as np
    import torch
    from speakerverification_tpu_torch.export import load_exported
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.utils.summary import forward_flops
    weights = tmp / "n1.pt"
    torch.save(seeded_model(70).state_dict(), weights)
    cfg = {**N_HPARAMS, "save_folder": str(tmp / "save"),
           "initial_model_infer": str(weights)}
    reset_counts()
    secs, out_dir = n_export_cli(tmp, "N1", cfg)
    counts = read_counts()
    pt2 = (out_dir / "model.pt2").stat().st_size
    n, T = cfg["num_eval"], int(cfg["audio_spec"]["sentence_len"]
                                * cfg["audio_spec"]["sample_rate"])
    x = np.random.default_rng(71).normal(0, 0.1, (n, T)).astype(np.float32)
    fresh = n_fresh_load(tmp, out_dir, x, "N1")

    engine = InferenceEngine(cfg)
    xt = torch.from_numpy(x).cuda()
    live = engine._embed(xt).cpu().numpy()
    cos = cosines(fresh["emb"], live)
    close = np.allclose(fresh["emb"], live, rtol=1e-4, atol=1e-5)
    ok = bool(np.isfinite(fresh["emb"]).all()) and close \
        and cos.min() >= 0.9999999
    log(f"[N1] Raw3_ECAPA [{n}, {T}] exported through the CLI in {secs:.1f} s "
        f"(self-check passed), model.pt2 {pt2:,} bytes; launches in the "
        f"export {counts}")
    log(f"[N1] fresh process ({fresh['wall']:.1f} s: imports "
        f"{fresh['import_s']:.1f}, load {fresh['load_s']:.1f}, first forward "
        f"{fresh['first_s']:.1f}): min cos {cos.min():.8f} (need >= "
        f"0.9999999), within rtol 1e-4 atol 1e-5 of the live engine: {close}; "
        f"kernels in the trace of one profiled forward: K1 {fresh['k1']}, "
        f"K2 {fresh['k2']} {'ok' if ok else 'FAIL'}")
    if not ok or (fresh["k1"], fresh["k2"]) != (1, 3):
        fail("path N1: the loaded program disagrees with the live engine or "
             "does not run K1 once and K2 3 times a forward")
    # here: the Python counters
    embed = load_exported(out_dir)
    embed(xt)
    torch.cuda.synchronize()
    reset_counts()
    here = embed(xt).cpu().numpy()
    torch.cuda.synchronize()
    per_forward = read_counts()
    log(f"[N1] the program loaded here: launches per forward {per_forward}")
    if per_forward != {"mel_frontend": 1, "res2net_cascade": 3,
                       "quant_matmul": 0} \
            or not np.allclose(here, live, rtol=1e-4, atol=1e-5):
        fail("path N1: the program here does not launch K1 once and K2 3 "
             "times a forward, or strays from the live engine")
    live_ms, program_ms = n_turns(lambda: engine._embed(xt),
                                  lambda: embed(xt))
    flops = forward_flops(engine._embed.module, xt)
    log(f"[N1] ms per forward at [{n}, {T}] (CUDA events, {N_REPS[1]} after "
        f"{N_REPS[0]}): loaded program {fresh['ms']:.3f} in its own process; "
        f"here, in turns (live, program, program, live): live engine "
        f"{live_ms}, program {program_ms} ({card})")
    if PROFILE_STEPS:           # path N alone: where the gap goes
        profile("N1 live fp32", None, None, fn=lambda: engine._embed(xt),
                host=True)
        profile("N1 program fp32", None, None, fn=lambda: embed(xt),
                host=True)
    live_ms, program_ms = min(live_ms), min(program_ms)
    log(f"[N1] forward_flops {flops / 1e9:.2f} GFLOP per forward "
        f"(FlopCounterMode): {flops / program_ms / 1e9:.2f} TFLOP/s achieved "
        f"by the loaded program, {flops / live_ms / 1e9:.2f} by the live "
        f"engine ({card})")
    # raw3_ecapa.yaml as it stands (random weights, conv_backend xla: K1
    # alone), its relative paths under a scratch directory
    from speakerverification_tpu_torch.config import read_config
    here_dir = os.getcwd()
    yaml_path = os.path.abspath("yaml/raw3_ecapa.yaml")
    os.chdir(tmp)
    try:
        reset_counts()
        y_secs, _ = n_export_cli(tmp, "N1 yaml", read_config(yaml_path),
                                 path=yaml_path)
        y_counts = read_counts()
    finally:
        os.chdir(here_dir)
    log(f"[N1 yaml] --do_export --config yaml/raw3_ecapa.yaml: "
        f"{y_secs:.1f} s, launches {y_counts}")
    if y_counts["mel_frontend"] < 2 or y_counts["res2net_cascade"] != 0:
        fail(f"path N1: raw3_ecapa.yaml's export launched {y_counts}")
    return {"counts": {k: counts[k] + per_forward[k] + y_counts[k]
                       for k in KERNELS},
            "export_s": secs, "pt2_bytes": pt2, "program_ms": program_ms,
            "fresh_ms": fresh["ms"], "live_ms": live_ms, "flops": flops, "live": live, "x": x,
            "cfg": cfg}


def path_n2(tmp, n1: dict, card: str) -> dict:
    """N2: the same export in bf16 (``--mixedprec``: K2's bf16 route),
    held to the fp32 engine at path C's bf16 bar."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.export import load_exported
    from speakerverification_tpu_torch.inference import InferenceEngine
    cfg = {**n1["cfg"], "save_folder": str(tmp / "save_bf16")}
    reset_counts()
    secs, out_dir = n_export_cli(tmp, "N2", cfg, ("--mixedprec",))
    counts = read_counts()
    embed = load_exported(out_dir)
    xt = torch.from_numpy(n1["x"]).cuda()
    embed(xt)
    torch.cuda.synchronize()
    reset_counts()
    got = embed(xt).cpu().numpy()
    torch.cuda.synchronize()
    per_forward = read_counts()
    engine = InferenceEngine({**cfg, "mixedprec": True})
    live_ms, program_ms = n_turns(lambda: engine._embed(xt),
                                  lambda: embed(xt))
    if PROFILE_STEPS:
        profile("N2 live bf16", None, None, fn=lambda: engine._embed(xt),
                host=True)
        profile("N2 program bf16", None, None, fn=lambda: embed(xt),
                host=True)
    live_ms, ms = min(live_ms), min(program_ms)
    cos = cosines(got, n1["live"])
    ok = bool(np.isfinite(got).all()) and cos.min() >= 0.99 and \
        per_forward == {"mel_frontend": 1, "res2net_cascade": 3,
                        "quant_matmul": 0}
    log(f"[N2] bf16 export through the CLI in {secs:.1f} s (self-check "
        f"passed), {(out_dir / 'model.pt2').stat().st_size:,} bytes; ms "
        f"per forward in turns: the program {program_ms}, the live bf16 "
        f"engine {live_ms} ({card}), launches {per_forward}; "
        f"against the fp32 engine min cos {cos.min():.5f}, mean "
        f"{cos.mean():.5f} (need >= 0.99) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path N2: the bf16 program strays or misses its kernels")
    return {"counts": {k: counts[k] + per_forward[k] for k in KERNELS},
            "export_s": secs, "program_ms": ms, "live_ms": live_ms}


def path_n3() -> None:
    """N3: int8 export refused by name (C.15), ONNX refused."""
    from speakerverification_tpu_torch.export import export_model, export_onnx
    for fn, args, errors, word in (
            (export_model, ({**N_HPARAMS, "quant": "int8"},),
             (NotImplementedError,), "C.15"),
            (export_onnx, ({},), (RuntimeError, NotImplementedError),
             "ONNX")):
        try:
            fn(*args)
        except errors as exc:
            if word not in str(exc):
                fail(f"path N3: {fn.__name__} refused without naming {word}")
            log(f"[N3] {fn.__name__} refused: {str(exc)[:90]}...")
        else:
            fail(f"path N3: {fn.__name__} did not refuse")


def n_feature_cases(dev):
    """(name, fn, inputs on the CPU, relative tolerance): every function of
    ops/signal.py, ops/features_extra.py and ops/filteraugment.py's cores
    at the sizes users feed them (waves [64, 16,000] with RIRs of 4,000
    taps, features [64, 201, 80], istft at the 8 kHz frontend's n_fft),
    each core with one set of draws for both devices."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.ops import features_extra as fx
    from speakerverification_tpu_torch.ops import filteraugment as fa
    from speakerverification_tpu_torch.ops import signal as sg
    from speakerverification_tpu_torch.ops.frontend import (
        FrontendConfig,
        dft_matrices,
    )
    rng = np.random.default_rng(80)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    B, T, nf, F = 64, 16000, 201, 80
    wave = t(rng.normal(0, 0.1, (B, T)))
    decay = np.exp(-np.arange(4000) / 600.0)
    rir = t(rng.normal(size=(B, 4000)) * decay)
    feats = t(rng.normal(2.0, 1.0, (B, nf, F)))
    power = t(rng.uniform(0, 1, (B, nf, F)) ** 6)
    cfg = FrontendConfig(pre_emphasis=None)
    cos_b, sin_b = dft_matrices(cfg.n_fft, cfg.win_length, cfg.window)
    pad = cfg.n_fft // 2
    frames = torch.nn.functional.pad(wave[:, None], (pad, pad),
                                     mode="reflect")[:, 0].unfold(
                                         -1, cfg.n_fft, cfg.hop_length)
    real, imag = frames @ t(cos_b), frames @ t(sin_b)
    dbs = t(rng.uniform(-60, 10, (B, T)))
    rot = torch.from_numpy(rng.integers(0, T, B))
    kernel = sg.notch_filter(0.25, 101)
    n_t = torch.arange(-200, 201, dtype=torch.float32)
    center, fwhm = t(rng.uniform(0.05, 3.0, F)), t(rng.uniform(2, 40, F))
    shifts = torch.from_numpy((rng.normal(0, 90, B)).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(B))
    widths = torch.from_numpy(rng.integers(1, 5, B))
    starts = torch.from_numpy(rng.integers(0, F - 5, B))
    lin = (4, torch.from_numpy(rng.integers(0, 40, 4)),
           t(rng.uniform(-6, 6, (B, 6))))
    step = (3, torch.from_numpy(rng.integers(0, 60, 3)),
            t(rng.uniform(-6, 6, (B, 4))))
    proto = (3, torch.from_numpy(rng.integers(1, F - 1, 3)),
             t(rng.uniform(-7.5, 6, (B, 4))))
    snr = t(rng.uniform(15, 30, (B, 1, 1)))
    noise = t(rng.normal(size=(B, nf, F)))
    return [
        ("compute_amplitude avg", lambda w: sg.compute_amplitude(w), (wave,),
         1e-5),
        ("compute_amplitude peak dB", lambda w: sg.compute_amplitude(
            w, amp_type="peak", scale="dB"), (wave,), 1e-5),
        ("normalize_amplitude", sg.normalize_amplitude, (wave,), 1e-5),
        ("rescale -12 dB", lambda w: sg.rescale(w, -12.0, scale="dB"),
         (wave,), 1e-5),
        ("db_to_amplitude", sg.db_to_amplitude, (dbs,), 1e-5),
        ("amplitude_to_db", sg.amplitude_to_db, (wave,), 1e-5),
        ("convolve1d fft, per-row rotation", lambda w, k, r: sg.convolve1d(
            w, k, use_fft=True, rotation_index=r), (wave, rir, rot), 1e-4),
        ("convolve1d direct, notch 101", lambda w, k: sg.convolve1d(
            w, k, padding=50, use_fft=False), (wave, kernel), 1e-5),
        ("reverberate, RIR 4000", sg.reverberate, (wave, rir), 1e-4),
        ("notch_filter 101", lambda d: sg.notch_filter(0.25, 101,
                                                       device=d.device),
         (torch.zeros(1),), 1e-5),
        ("overlap_and_add [64, 201, 512]", lambda f: sg.overlap_and_add(
            f, 80), (frames,), 1e-5),
        ("gabor_impulse_response [80, 401]", sg.gabor_impulse_response,
         (n_t, center, fwhm), 1e-5),
        ("deltas", fx.deltas, (feats,), 1e-5),
        ("context_window 5+5", fx.context_window, (feats,), 0.0),
        ("istft n_fft 512 hop 80", lambda r, i: fx.istft(r, i, cfg),
         (real, imag), 1e-5),
        ("speechbrain_log_fbank", fx.speechbrain_log_fbank, (power,), 1e-5),
        ("frame_shift_apply", fa.frame_shift_apply, (feats, shifts), 0.0),
        ("mixup_apply", lambda x, p: fa.mixup_apply(x, p, 0.3),
         (feats, perm), 1e-6),
        ("time_mask_apply", lambda x: fa.time_mask_apply(x, 15, 40),
         (feats,), 0.0),
        ("filt_aug_apply linear", lambda x, r, g: fa.filt_aug_apply(
            x, lin[0], r, g), (feats, lin[1], lin[2]), 1e-5),
        ("filt_aug_apply step", lambda x, r, g: fa.filt_aug_apply(
            x, step[0], r, g, 4, "step"), (feats, step[1], step[2]), 1e-5),
        ("filt_aug_prototype_apply", lambda x, r, g:
         fa.filt_aug_prototype_apply(x, proto[0], r, g),
         (feats, proto[1], proto[2]), 1e-5),
        ("freq_mask_apply", fa.freq_mask_apply, (feats, widths, starts),
         0.0),
        ("add_noise_apply", fa.add_noise_apply, (feats, snr, noise), 1e-5),
    ]


def path_n4(card: str) -> list:
    """N4: the feature-domain ops on the card against the same call on the
    CPU, each timed; the random ops drawing from a generator on the card."""
    import torch
    from speakerverification_tpu_torch.ops import filteraugment as fa
    dev = torch.device("cuda", 0)
    rows = []
    for name, fn, args, tol in n_feature_cases(dev):
        ref = fn(*args)
        on_dev = [a.to(dev) for a in args]
        got = fn(*on_dev)
        torch.cuda.synchronize()
        if got.device.type != "cuda" or got.shape != ref.shape:
            fail(f"path N4: {name} gave {got.shape} on {got.device}")
        diff = (got.cpu() - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-6)
        ms = cuda_ms(lambda: fn(*on_dev), iters=10, warmup=2)
        ok = diff <= tol * scale and bool(torch.isfinite(got).all())
        rows.append({"op": name, "ms": round(ms, 4),
                     "max_abs_err": diff, "rel_err": diff / scale})
        log(f"[N4] {name:38s} {ms:8.4f} ms on the card, largest error "
            f"{diff:.3e} ({diff / scale:.2e} of max|ref|, need <= {tol:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"path N4: {name} on the card disagrees with the CPU")
    gen = torch.Generator(device=dev).manual_seed(81)
    x = torch.randn(64, 201, 80, device=dev, generator=gen) + 2.0
    for name, op in (("frame_shift", fa.frame_shift), ("mixup", fa.mixup),
                     ("time_mask", fa.time_mask), ("filt_aug", fa.filt_aug),
                     ("filt_aug_prototype", fa.filt_aug_prototype),
                     ("freq_mask", fa.freq_mask), ("add_noise", fa.add_noise),
                     ("feature_transformation", lambda g, y: torch.stack(
                         fa.feature_transformation(g, y, 2,
                                                   (True, True, True))))):
        y = op(gen, x)
        ms = cuda_ms(lambda: op(gen, x), iters=10, warmup=2)
        if y.shape[-3:] != x.shape or not bool(torch.isfinite(y).all()):
            fail(f"path N4: {name} with the card's generator gave {y.shape}")
        log(f"[N4] {name:38s} {ms:8.4f} ms on the card (draws included)")
        rows.append({"op": name + " (draws)", "ms": round(ms, 4)})
    log(f"[N4 table] {json.dumps(rows)} ({card})")
    return rows


def path_n5(tmp, n1: dict, card: str) -> dict:
    """N5: ``--list_components`` and ``--sys_info`` through the CLI, then a
    2-step first epoch of the default stack with ``profile: true``."""
    import io

    import torch
    from speakerverification_tpu_torch.cli.main import main as cli_main
    for args, want in ((["--list_components"], 4), (["--sys_info"], None)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(args)
        text = out.getvalue()
        if rc != 0:
            fail(f"path N5: {args[0]} exited {rc}")
        if want is not None:
            lines = text.strip().splitlines()
            if len(lines) != want:
                fail(f"path N5: {args[0]} printed {len(lines)} lines")
            log(f"[N5] {args[0]}: " + "; ".join(ln.split(':')[0]
                                               for ln in lines))
        else:
            limit = card.split(",")[-1].strip()
            if torch.cuda.get_device_name(0) not in text or limit not in text:
                fail(f"path N5: --sys_info lacks the card ({card})")
            for line in text.splitlines():
                if any(k in line for k in ("torch_version", "cuda_version",
                                           "devices", "gpus")):
                    log(f"[N5 sys_info] {line.strip()}")
    # the trainer's profile: a first epoch of 2 steps (64 speakers, 3
    # WAVs each, 32 x 2 crops a step)
    h = RAW3_TRAIN_HPARAMS
    trials, _ = write_train_corpus(tmp / "n5", h["audio_spec"]["sample_rate"],
                                   n_spk=64, n_utt=3)
    prof_dir = tmp / "n5" / "profile"
    cfg = {**h, "number_of_epochs": 1, "save_folder": str(tmp / "n5" / "save"),
           "data_folder": str(tmp / "n5" / "data"),
           "train_annotation": str(tmp / "n5" / "meta" / "train.csv"),
           "evaluation_file": str(trials), "pretrained": {"use": False},
           "profile": True, "profile_dir": str(prof_dir)}
    path = tmp / "n5" / "train.yaml"
    path.write_text(json.dumps(cfg, indent=1))
    out = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--do_train", "--config", str(path)])
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = read_counts()
    text = out.getvalue()
    trace = prof_dir / "trace.json"
    if rc != 0 or f"profiler trace written to {prof_dir}" not in text \
            or not trace.exists():
        fail(f"path N5: --do_train with profile rc {rc}:\n{text[-2000:]}")
    # the trace names K1; late in a long process the profiler may miss
    # some of the ctypes libraries' kernels (1 of 2 in one whole run), so
    # it is not held to the launch count
    k1 = trace_kernels(trace, "mel_kernel")
    log(f"[N5] --do_train, profile: true: {secs:.1f} s, launches {counts}; "
        f"trace.json {trace.stat().st_size:,} bytes, K1 kernel events {k1} "
        f"({card})")
    if k1 < 1 or counts["mel_frontend"] != 2:
        fail(f"path N5: trace.json holds {k1} K1 kernels for "
             f"{counts['mel_frontend']} launches")
    return {"counts": counts}


def path_n(tmp, card: str) -> dict:
    """The thirteenth slice (N1-N5): export through torch.export with K1
    and K2 as registered operators, the feature-domain ops, the tools."""
    walls = {}

    def timed_phase(phase, fn, *args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        walls[phase] = round(time.time() - t0, 1)
        return out

    n1 = timed_phase("N1", path_n1, tmp, card)
    n2 = timed_phase("N2", path_n2, tmp, n1, card)
    timed_phase("N3", path_n3)
    n4 = timed_phase("N4", path_n4, card)
    n5 = timed_phase("N5", path_n5, tmp, n1, card)
    counts = {k: n1["counts"][k] + n2["counts"][k] + n5["counts"][k]
              for k in KERNELS}
    log(f"[N] launches over N1-N5: {counts}; wall by phase (s) {walls}, "
        f"{sum(walls.values()):.1f} s in all")
    log("[N table] " + json.dumps({
        "card": card, "export_s": round(n1["export_s"], 1),
        "pt2_bytes": n1["pt2_bytes"], "program_ms": n1["program_ms"],
        "fresh_program_ms": n1["fresh_ms"], "live_ms": n1["live_ms"], "gflop_per_forward": n1["flops"] / 1e9,
        "program_tflops": n1["flops"] / n1["program_ms"] / 1e9,
        "bf16_export_s": round(n2["export_s"], 1),
        "bf16_program_ms": n2["program_ms"],
        "bf16_live_ms": n2["live_ms"], "walls": walls}))
    if counts["mel_frontend"] < 1 or counts["res2net_cascade"] < 3 \
            or counts["quant_matmul"] != 0:
        fail(f"path N: unexpected launches {counts}")
    return {"counts": counts, "feature_ops": n4}


def export_tools() -> None:
    """Path N alone, after the kernels' build: the quick check of the
    thirteenth slice."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_export_"))
    try:
        out = path_n(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[N] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


# ----------------------------------------------------------------------
# path O: the multi-GPU code on one card (--multi-gpu)
# ----------------------------------------------------------------------
# path O runs on the card; tests/test_torch_port_parallel_smoke.py sets
# "cpu" and small sizes. NCCL refuses two ranks on one GPU, so the NCCL
# path runs at world size 1 (O1) and the multi-rank math as two ranks on
# cuda:0 over gloo, which stages CUDA tensors through the host.
O_DEVICE = "cuda"
# the default stack (O1, O2; O3 and O6 with AAmSoftmax) and the served
# model of O4's eval data parallelism (its ECAPA branch through K2)
O_H = RAW3_TRAIN_HPARAMS
O_EMBED_H = {**RAW3_ECAPA_HPARAMS, "model": {
    **RAW3_ECAPA_HPARAMS["model"], "conv_backend": "pallas"}}
# O3 steps on 16 x 2 crops, O2's shard
O_SIZES = {"speakers": 32, "tp_speakers": 16, "tp_classes": 5994,
           "bank_rows": 1_000_000, "bank_dim": 512, "bank_queries": 64,
           "embed_crops": 40, "cli_speakers": 48, "o1_steps": 3}
O_BARS = {"o1_rel": 1e-6, "o2_loss": 1e-4, "grad_cos": 0.9999,
          "o3_metrics": 1e-5, "bank_scores": 1e-6, "embed_cos": 0.9999999,
          "cli_scores": 1e-5}
AAM = {"name": "AAmSoftmax", "margin": 0.2, "scale": 30}


def o_device():
    import torch
    return torch.device(O_DEVICE, 0) if O_DEVICE == "cuda" \
        else torch.device(O_DEVICE)


def o_sync() -> None:
    import torch
    if O_DEVICE == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def o_same_convs():
    """cuDNN off: O2's and O3's steps and their one-process references
    then run PyTorch's own convolutions, whose plans do not depend on
    timing or free memory, so every process rounds alike. With cuDNN
    each process times its own plans; two ranks sharing one card can
    pick others than the reference did, and the raw branch's sinc
    gradients turn that rounding into differences at the percent level
    (path E1)."""
    import torch
    cudnn = torch.backends.cudnn
    was = cudnn.enabled
    cudnn.enabled = False
    try:
        yield
    finally:
        cudnn.enabled = was


_O_INITIAL: dict = {}      # (hparams, seed, ranks) -> the initial state


def o_state(h, seed: int = 7, num_devices: int = 1, record=None):
    """``(model, tx, state)`` of ``h``'s stack on path O's device, the
    weights drawn from ``seed`` (built once, then copied: flax's
    initializers on the host take seconds at full width); with
    ``record`` (a dict), the optimizer keeps each update's incoming
    gradients in ``record["grads"]``."""
    import copy
    from speakerverification_tpu_torch.builder import (
        encoder_from_hparams,
        optimizer_from_hparams,
    )
    from speakerverification_tpu_torch.optim import GradientTransformation
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    key = (json.dumps(h, sort_keys=True), seed, num_devices)
    if key not in _O_INITIAL:
        model = encoder_from_hparams(h, with_loss=True,
                                     num_devices=num_devices).to(o_device())
        _O_INITIAL[key] = create_train_state(model, optimizer_from_hparams(h),
                                             seed)
    state = copy.deepcopy(_O_INITIAL[key])
    model = state.model
    tx = optimizer_from_hparams(h)
    if record is not None:
        inner = tx

        def update(grads, opt_state, params):
            record["grads"] = {k: g.detach().clone()
                               for k, g in grads.items()}
            return inner.update(grads, opt_state, params)
        tx = GradientTransformation(inner.init, update)
    return model, tx, state


def o_batch(h, seed: int, speakers=None):
    import torch
    wave, label = seeded_batch(seed, speakers or O_SIZES["speakers"], 2, h)
    return (torch.from_numpy(wave).to(o_device()),
            torch.from_numpy(label).to(o_device()))


def leaf_cosines(got: dict, want: dict, skip=ZERO_GRAD) -> tuple:
    """The lowest per-leaf cosine of two gradient trees and its leaf
    (leaves ``skip`` names, whose gradient is zero by construction, left
    out)."""
    worst, name = 2.0, ""
    for k, w in want.items():
        if k.endswith(skip):
            continue
        a, b = got[k].double().ravel().cpu(), w.double().ravel().cpu()
        c = float(a @ b / max(float(a.norm() * b.norm()), 1e-300))
        if c < worst:
            worst, name = c, k
    return worst, name


def trees_equal(a, b, path: str = "") -> str:
    """'' when two msgpack trees are equal leaf for leaf, else where not."""
    import numpy as np
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) \
                or set(a) != set(b):
            return path or "<root>"
        for k in a:
            where = trees_equal(a[k], b[k], f"{path}/{k}")
            if where:
                return where
        return ""
    x, y = np.asarray(a), np.asarray(b)
    return "" if x.dtype == y.dtype and np.array_equal(x, y) else path


def path_o1(tmp, card: str) -> dict:
    """O1: the data-parallel step over NCCL at world size 1 against the
    plain step, ``o1_steps`` steps each from the same state with
    deterministic convolution plans; ms per step; K1 counted in one
    profiled DP step."""
    import torch
    import torch.distributed as dist
    from speakerverification_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
        maybe_initialize_distributed,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    h = O_H
    maybe_initialize_distributed({
        "coordinator_address": f"file://{tmp / 'o1_store'}",
        "num_processes": 1, "process_id": 0,
        "distributed_backend": "nccl" if O_DEVICE == "cuda" else "gloo",
        "device": O_DEVICE})
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic
    try:
        mesh = make_mesh()
        model_p, tx_p, plain = o_state(h)
        model_d, tx_d, dp = o_state(h)
        steps = {"plain": (make_train_step(model_p, tx_p), plain),
                 "DP": (make_dp_train_step(model_d, tx_d, mesh), dp)}
        cudnn.deterministic = True
        times = {k: [] for k in steps}
        for i in range(O_SIZES["o1_steps"]):
            wave, label = o_batch(h, 60 + i)
            for name, (step, state) in steps.items():
                o_sync()
                t0 = time.time()
                step(state, wave, label, h["lr"])
                o_sync()
                times[name].append((time.time() - t0) * 1e3)
        worst, at, equal = 0.0, "", True
        for k, p in plain.params.items():
            p, q = p.detach(), dp.params[k].detach()
            equal = equal and torch.equal(p, q)
            rel = float((p - q).abs().max() / p.abs().max().clamp_min(1e-30))
            if rel > worst:
                worst, at = rel, k
        stats_equal = all(torch.equal(v, dp.batch_stats[k])
                          for k, v in plain.batch_stats.items())
        ok = worst <= O_BARS["o1_rel"]
        ms = {k: sum(v[1:]) / max(len(v) - 1, 1) for k, v in times.items()}
        log(f"[O1] the DP step over {dist.get_backend()} at world size "
            f"{dist.get_world_size()} vs the plain step, "
            f"{O_SIZES['o1_steps']} steps of {2 * O_SIZES['speakers']} crops "
            f"each from one state: parameters bit for bit {equal}, BN "
            f"statistics bit for bit {stats_equal}, largest relative "
            f"difference {worst:.3e}{' at ' + at if at else ''} (bar "
            f"{O_BARS['o1_rel']:g}) {'ok' if ok else 'FAIL'}")
        log(f"[O1] ms per step (host wall, synchronized, the steps after "
            f"the first): plain {ms['plain']:.2f}, DP {ms['DP']:.2f} "
            f"({card})")
        if not ok:
            fail("path O1: the world-size-1 DP step disagrees with the "
                 "plain step")
        cudnn.deterministic = was
        # one profiled DP step: K1 among its kernels
        wave, label = o_batch(h, 70)
        before = read_counts()["mel_frontend"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if O_DEVICE == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            steps["DP"][0](dp, wave, label, h["lr"])
            o_sync()
        launched = read_counts()["mel_frontend"] - before
        k1 = [e for e in prof.key_averages() if "mel_kernel" in e.key]
        k1_ms = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in k1) / 1e3
        log(f"[O1] a profiled DP step: K1 launched {launched} time(s), "
            f"{sum(e.count for e in k1)} mel_kernel event(s) in its trace, "
            f"{k1_ms:.3f} ms of device time")
        # the launch count decides: in a long process the profiler may
        # miss the ctypes libraries' kernels (PERF.md §7)
        if launched < 1:
            fail("path O1: K1 did not run in the profiled DP step")
        return {"ms": ms, "bit_equal": equal, "rel": worst}
    finally:
        cudnn.deterministic = was
        dist.destroy_process_group()


def o_rank_main(world: int, workdir) -> None:
    """One rank of O2, O3 and O5 (``chip_smoke.py --o-rank``, its rank in
    ``SVTPU_PROCESS_ID``): joins a gloo group through a file store in
    ``workdir`` and writes its results to ``workdir/out_<rank>.pt``."""
    import os
    from pathlib import Path

    import torch
    import torch.distributed as dist
    workdir = Path(workdir)
    rank = int(os.environ["SVTPU_PROCESS_ID"])
    cfg = json.loads((workdir / "o_inputs.json").read_text())
    global O_DEVICE, O_H, O_SIZES
    O_DEVICE, O_H, O_SIZES = cfg["device"], cfg["h"], cfg["sizes"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from speakerverification_tpu_torch import checkpoint as codec
    from speakerverification_tpu_torch.parallel import (
        make_dp_tp_train_step,
        make_dp_train_step,
        make_mesh,
        maybe_initialize_distributed,
        shard_batch,
        shard_state_tp,
    )
    from speakerverification_tpu_torch.parallel.tp import state_leaves
    from speakerverification_tpu_torch.training import (
        checkpoint_sharded as cs,
    )
    from speakerverification_tpu_torch.training.checkpoint import (
        state_to_jax,
    )
    maybe_initialize_distributed({"distributed_backend": "gloo",
                                  "device": O_DEVICE})
    out = {"phases": {}}
    reset_counts()
    t_phase = time.time()

    def phase(name):
        nonlocal t_phase
        out["phases"][name] = round(time.time() - t_phase, 2)
        t_phase = time.time()
    phase("start-up")
    # O2: data parallel over the two ranks, each on its half of the batch
    h = {**O_H, "distributed": True}
    rec: dict = {}
    model, tx, state = o_state(h, num_devices=world, record=rec)
    mesh = make_mesh()
    step = make_dp_train_step(model, tx, mesh)
    wave, label = seeded_batch(50, O_SIZES["speakers"], 2, h)
    b = shard_batch({"wave": wave, "label": label}, mesh, device=o_device())
    phase("O2 build")
    with o_same_convs():
        state, m = step(state, b["wave"], b["label"], h["lr"])
    o_sync()
    out["o2"] = {"loss": float(m["loss"]), "prec1": float(m["prec1"]),
                 "stats": {k: v.detach().cpu().clone()
                           for k, v in state.batch_stats.items()},
                 "grads": ({k: g.cpu() for k, g in rec["grads"].items()}
                           if rank == 0 else None),
                 "crops": int(b["wave"].shape[0] * b["wave"].shape[1])}
    phase("O2 first step")
    # a second step for the wall
    t0 = time.time()
    with o_same_convs():
        step(state, b["wave"], b["label"], h["lr"])
    o_sync()
    out["o2"]["wall_s"] = time.time() - t0
    phase("O2 second step")
    del model, tx, state, step
    # O3: data 1 x model 2, the class-sharded head
    h3 = {**h, "criterion": AAM, "nClasses": O_SIZES["tp_classes"],
          "model_parallel": 2}
    rec = {}
    model, tx, state = o_state(h3, num_devices=world, record=rec)
    mesh2 = make_mesh(("data", "model"), (world // 2, 2))
    state = shard_state_tp(state, mesh2)
    step = make_dp_tp_train_step(model, tx, mesh2, state)
    wave, label = seeded_batch(50, O_SIZES["tp_speakers"], 2, h3)
    b = shard_batch({"wave": wave, "label": label}, mesh2, device=o_device())
    phase("O3 build")
    o_sync()
    t0 = time.time()
    with o_same_convs():
        state, m = step(state, b["wave"], b["label"], h3["lr"])
    o_sync()
    phase("O3 step")
    leaves = dict(state_leaves(state))
    out["o3"] = {"loss": float(m["loss"]), "prec1": float(m["prec1"]),
                 "wall_s": time.time() - t0,
                 "head_bytes": {p: leaves[p].numel() * leaves[p].element_size()
                                for p in state.shards},
                 "rows": [v[:2] for v in state.shards.values()][0],
                 "grads": {k: g.cpu() for k, g in rec["grads"].items()
                           if k.startswith("loss.") or rank == 0}}
    # O5: O3's state saved sharded, asynchronously, and as msgpack
    timings = {}
    t0 = time.time()
    cs.save_sharded(workdir / "o5_sync", state, meta={"step": state.step})
    timings["save_s"] = time.time() - t0
    t0 = time.time()
    cs.async_save_sharded(workdir / "o5_async", state)
    timings["async_return_s"] = time.time() - t0
    cs.wait(workdir / "o5_async")
    timings["async_durable_s"] = time.time() - t0
    t0 = time.time()
    tree = state_to_jax(state)
    if rank == 0:
        codec.save_checkpoint(workdir / "o3.msgpack", tree)
    timings["msgpack_s"] = time.time() - t0
    out["o5"] = timings
    phase("O5 saves")
    del model, tx, state, step
    # O6: the CLI in these two ranks (the SVTPU_* variables name them)
    import contextlib
    import io
    import shutil
    from speakerverification_tpu_torch.cli.main import main as cli_main
    dev_args = [] if O_DEVICE == "cuda" else ["--device", O_DEVICE]
    o6 = {}
    for verb, args in (("train", ["--do_train", "--model_parallel", "2"]),
                       ("eval", ["--do_infer", "--eval"])):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([*args, "--config", cfg["o6"], "--distributed",
                           "--distributed_backend", "gloo", *dev_args])
        o6[verb] = {"rc": rc, "s": time.time() - t0, "out": buf.getvalue()}
        phase(f"O6 {' '.join(args)}")
    if rank == 0:
        result = Path(cfg["o6_result"])
        shutil.move(result, result.with_name("split_" + result.name))
    out["o6"] = o6
    out["counts"] = read_counts()
    torch.save(out, workdir / f"out_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def o_spawn(args, workdir, world: int = 2, timeout: float = 600.0) -> list:
    """``world`` processes of ``python args`` from the repo's root, wired
    by the ``SVTPU_*`` variables through a file store in ``workdir``;
    fails the script when one fails. Returns their outputs."""
    import os
    from pathlib import Path
    root = Path(__file__).resolve().parent
    store = workdir / f"store-{time.time_ns()}"
    procs = []
    for r in range(world):
        env = {**os.environ, "SVTPU_COORDINATOR": f"file://{store}",
               "SVTPU_NUM_PROCESSES": str(world),
               "SVTPU_PROCESS_ID": str(r), "LOCAL_RANK": "0",
               # the host's cores shared between the ranks
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2)
                                         // world)),
               "PYTHONPATH": os.pathsep.join(
                   [str(root), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, *[str(a) for a in args]], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        log(f"[O rank {r} of {' '.join(map(str, args[:3]))}]\n"
            + (outs[r][-6000:] if r < len(outs) else ""))
    if bad:
        fail(f"path O: ranks {bad} of {' '.join(map(str, args[:3]))} failed")
    return outs


def path_o_ranks(tmp, card: str) -> dict:
    """O2, O3 and O5 in two ranks on one device over gloo, against the
    one-process references computed here first."""
    import torch
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    h = O_H
    wave, label = o_batch(h, 50)
    # the references: accumulate_steps 2 on the whole batch (O2), and the
    # unsharded head (O3)
    rec2: dict = {}
    model, tx, state = o_state(h, record=rec2)
    with o_same_convs():
        state, m2 = make_train_step(model, tx, accum_steps=2)(
            state, wave, label, h["lr"])
    ref2 = {"loss": float(m2["loss"]), "grads": rec2["grads"],
            "stats": {k: v.clone() for k, v in state.batch_stats.items()}}
    h3 = {**h, "criterion": AAM, "nClasses": O_SIZES["tp_classes"]}
    wave, label = o_batch(h3, 50, O_SIZES["tp_speakers"])
    rec3: dict = {}
    model, tx, state = o_state(h3, record=rec3)
    with o_same_convs():
        state, m3 = make_train_step(model, tx)(state, wave, label, h["lr"])
    ref3 = {"loss": float(m3["loss"]), "prec1": float(m3["prec1"]),
            "grads": rec3["grads"]}
    del model, tx, state
    if O_DEVICE == "cuda":
        torch.cuda.empty_cache()
    work = tmp / "o_ranks"
    work.mkdir()
    o6_path, o6_run, n_trials = o6_config(tmp)
    (work / "o_inputs.json").write_text(json.dumps(
        {"device": O_DEVICE, "h": h, "sizes": O_SIZES, "o6": str(o6_path),
         "o6_result": str(o6_run / "result" / "evaluation_results.csv")}))
    t0 = time.time()
    o_spawn([script_path(), "--o-rank", "2", work], work)
    wall = time.time() - t0
    ranks = [torch.load(work / f"out_{r}.pt", weights_only=False)
             for r in range(2)]
    # O2
    r0, r1 = ranks[0]["o2"], ranks[1]["o2"]
    loss_rel = abs(r0["loss"] - ref2["loss"]) / abs(ref2["loss"])
    cos, at = leaf_cosines(r0["grads"], ref2["grads"])
    stats_same = all(torch.equal(r0["stats"][k], r1["stats"][k])
                     for k in r0["stats"])
    stats_rel = max(float((r0["stats"][k] - v.cpu()).abs().max()
                          / v.abs().max().clamp_min(1e-30))
                    for k, v in ref2["stats"].items())
    ok = (loss_rel <= O_BARS["o2_loss"] and cos >= O_BARS["grad_cos"]
          and stats_same)
    log(f"[O2] two ranks on one device over gloo, {r0['crops']} crops each, "
        f"vs one process with accumulate_steps 2 on the whole batch: loss "
        f"{r0['loss']:.6f} vs {ref2['loss']:.6f} (rel {loss_rel:.2e}, bar "
        f"{O_BARS['o2_loss']:g}), lowest gradient cosine {cos:.7f} at {at} "
        f"(bar {O_BARS['grad_cos']}); BN statistics equal on both ranks "
        f"{stats_same} (their mean; largest relative difference to the "
        f"accumulated step's {stats_rel:.2e}); a second step's wall "
        f"(cuDNN off on both sides) rank 0 {r0['wall_s'] * 1e3:.1f} ms, "
        f"rank 1 "
        f"{r1['wall_s'] * 1e3:.1f} ms ({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path O2: the two-rank DP step disagrees with the accumulated "
             "step")
    # O3
    a, b = ranks[0]["o3"], ranks[1]["o3"]
    got = {k: (torch.cat([a["grads"][k], b["grads"][k]])
               if k.startswith("loss.") else g) for k, g in a["grads"].items()}
    cos3, at3 = leaf_cosines(got, ref3["grads"])
    dl = abs(a["loss"] - ref3["loss"]) / abs(ref3["loss"])
    dp1 = abs(a["prec1"] - ref3["prec1"])
    ok = (dl <= O_BARS["o3_metrics"] and dp1 <= O_BARS["o3_metrics"]
          and cos3 >= O_BARS["grad_cos"] and a["loss"] == b["loss"])
    log(f"[O3] data 1 x model 2 on one device, AAmSoftmax over "
        f"{O_SIZES['tp_classes']} classes, {2 * O_SIZES['tp_speakers']} "
        f"crops, vs the unsharded step: loss "
        f"{a['loss']:.6f} vs {ref3['loss']:.6f} (rel {dl:.2e}), prec1 "
        f"{a['prec1']:.4f} vs {ref3['prec1']:.4f} (bar "
        f"{O_BARS['o3_metrics']:g}), lowest gradient cosine {cos3:.7f} at "
        f"{at3} (bar {O_BARS['grad_cos']}); rows per rank {a['rows']}, "
        f"{b['rows']}; bytes per rank of the head and its moments "
        f"{sum(a['head_bytes'].values())}, {sum(b['head_bytes'].values())} "
        f"({a['head_bytes']}); the step's wall {a['wall_s'] * 1e3:.1f} ms "
        f"(cuDNN off on both sides) ({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path O3: the class-sharded step disagrees with the unsharded")
    o5 = path_o5(work, ranks, card)
    counts = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k]
              for k in KERNELS}
    log(f"[O2-O6] the two ranks' wall {wall:.1f} s, rank 0's phases (s) "
        f"{json.dumps(ranks[0]['phases'])}; their launches {counts}")
    o6 = path_o6(o6_path, o6_run, n_trials, [r["o6"] for r in ranks], card)
    return {"counts": counts, "o5": o5, "o6": o6}


def script_path():
    from pathlib import Path
    return Path(__file__).resolve()


def _du(path) -> int:
    from pathlib import Path
    p = Path(path)
    return sum(f.stat().st_size for f in p.rglob("*") if f.is_file()) \
        if p.is_dir() else p.stat().st_size


def path_o5(work, ranks, card: str) -> dict:
    """O5: O3's sharded checkpoints read into one process (world size 1)
    equal the state the ranks gathered (its msgpack), bit for bit; so
    does the msgpack read back."""
    from speakerverification_tpu_torch import checkpoint as codec
    from speakerverification_tpu_torch.training import (
        checkpoint_sharded as cs,
    )
    from speakerverification_tpu_torch.training.checkpoint import (
        load_checkpoint,
        state_to_jax,
    )
    # targets of the unsharded head (the parameters keep their names):
    # copies of O3's reference state, whose values the reads replace
    h3 = {**O_H, "criterion": AAM, "nClasses": O_SIZES["tp_classes"]}
    gathered = codec.load_checkpoint(work / "o3.msgpack")
    where = {}
    for name in ("o5_sync", "o5_async"):
        _, _, state = o_state(h3)
        cs.restore_sharded(work / name, state)
        where[name] = trees_equal(state_to_jax(state), gathered)
    _, _, state = o_state(h3)
    load_checkpoint(work / "o3.msgpack", state)
    where["msgpack"] = trees_equal(state_to_jax(state), gathered)
    ok = not any(where.values())
    t = [r["o5"] for r in ranks]
    sizes = {"sharded": _du(work / "o5_sync"),
             "sharded async": _du(work / "o5_async"),
             "msgpack": _du(work / "o3.msgpack")}
    log(f"[O5] O3's state read into one process from the sharded save, "
        f"the async save and the msgpack, each against the state the ranks "
        f"gathered: equal bit for bit {'yes' if ok else where} "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[O5] seconds on rank 0 / 1: save_sharded "
        f"{t[0]['save_s']:.3f} / {t[1]['save_s']:.3f}, async_save_sharded "
        f"returns {t[0]['async_return_s']:.3f} / {t[1]['async_return_s']:.3f} "
        f"and is durable after {t[0]['async_durable_s']:.3f} / "
        f"{t[1]['async_durable_s']:.3f}, the msgpack (gather, rank 0 "
        f"writes) {t[0]['msgpack_s']:.3f} / {t[1]['msgpack_s']:.3f}; bytes "
        f"{sizes} ({card})")
    if not ok:
        fail("path O5: a restored state differs from the gathered state")
    return {"seconds": t, "bytes": sizes}


def path_o4(card: str) -> dict:
    """O4: a ShardedSpeakerBank of two shards on one device against the
    one-device bank, timed; the eval embedding split over the device
    named twice (K1 and K2) against one device."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.builder import encoder_from_hparams
    from speakerverification_tpu_torch.evaluation.bank import (
        ShardedSpeakerBank,
        SpeakerBank,
    )
    from speakerverification_tpu_torch.inference import make_eval_embed_fn
    from speakerverification_tpu_torch.weights import init_weights_
    dev = o_device()
    N, D, Q = (O_SIZES["bank_rows"], O_SIZES["bank_dim"],
               O_SIZES["bank_queries"])
    gen = torch.Generator(device=dev).manual_seed(81)
    rows = torch.randn(N, D, generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    pick = torch.randint(0, N, (Q,), generator=gen, device=dev)
    queries = rows[pick] + 0.05 * torch.randn(Q, D, generator=gen,
                                              device=dev)
    one = SpeakerBank(rows, device=dev)
    many = ShardedSpeakerBank(rows, devices=[dev, dev])
    del rows
    s1, i1 = one.identify(queries, k=5)
    s2, i2 = many.identify(queries, k=5)
    err = float(np.abs(s1 - s2).max())
    found = bool((i2[:, 0] == pick.cpu().numpy()).all())
    ok = bool((i1 == i2).all()) and err <= O_BARS["bank_scores"] and found
    timer = (lambda fn: cuda_ms(fn, iters=10)) if O_DEVICE == "cuda" else \
        (lambda fn: (lambda t0: (fn(), (time.time() - t0) * 1e3)[1])(
            time.time()))
    ms_one = timer(lambda: one.identify(queries, k=5))
    ms_many = timer(lambda: many.identify(queries, k=5))
    log(f"[O4 bank] {N:,} x {D} in two shards on one device vs one bank, "
        f"{Q} queries, top 5: indices equal {bool((i1 == i2).all())}, each "
        f"query's row first {found}, scores max |diff| {err:.2e} (bar "
        f"{O_BARS['bank_scores']:g}); ms per identify: one bank "
        f"{ms_one:.3f}, sharded {ms_many:.3f}; "
        f"{many.nbytes / 1e9:.3f} GB in {many.n_dev} shards of "
        f"{many.shard_rows:,} rows ({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path O4: the sharded bank disagrees with the one-device bank")
    del one, many
    if O_DEVICE == "cuda":
        torch.cuda.empty_cache()
    h = O_EMBED_H
    model = encoder_from_hparams(h)
    init_weights_(model, torch.Generator().manual_seed(13))
    randomize_bn_(model, 14)
    model = model.to(dev)
    spec = h["audio_spec"]
    samples = int(spec["sentence_len"] * spec["sample_rate"])
    waves = torch.from_numpy((0.1 * np.random.default_rng(15).normal(
        0, 1, (O_SIZES["embed_crops"], samples))).astype(np.float32))
    want = make_eval_embed_fn(model)(waves)
    split = make_eval_embed_fn(model, devices=[dev, dev])
    before = read_counts()
    got = split(waves)
    o_sync()
    launched = {k: read_counts()[k] - before[k] for k in KERNELS}
    cos = float(torch.nn.functional.cosine_similarity(
        got.double(), want.double(), dim=1).min())
    ok = cos >= O_BARS["embed_cos"] and tuple(got.shape) == tuple(
        want.shape)
    if O_DEVICE == "cuda":
        ok = ok and launched["mel_frontend"] >= 1 \
            and launched["res2net_cascade"] >= 1
    log(f"[O4 eval] {h['model']['name']} with conv_backend pallas, "
        f"{len(waves)} crops split over the device named twice vs one "
        f"device: min cosine {cos:.9f} (bar {O_BARS['embed_cos']}); "
        f"launches in the split call {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path O4: the split eval embedding disagrees or skipped K1/K2")
    return {"ms_one": ms_one, "ms_sharded": ms_many, "cos": cos}


def o6_config(tmp):
    """O6's corpus (``cli_speakers`` speakers' WAVs, a trial list) and its
    config: the default stack's keys with AAmSoftmax, one epoch, sharded
    checkpoints. Returns ``(config path, run directory, trials)``."""
    root = tmp / "o6"
    trials, n_trials = write_train_corpus(
        root, O_H["audio_spec"]["sample_rate"], n_spk=O_SIZES["cli_speakers"])
    cfg = {**O_H, "criterion": AAM, "nClasses": O_SIZES["tp_classes"],
           "number_of_epochs": 1, "sharded_checkpoints": True,
           "save_folder": str(root / "save"),
           "data_folder": str(root / "data"),
           "train_annotation": str(root / "meta" / "train.csv"),
           "evaluation_file": str(trials), "pretrained": {"use": False}}
    path = root / "o6.yaml"
    path.write_text(json.dumps(cfg, indent=1))
    return path, root / "save" / O_H["model"]["name"] / "AAmSoftmax", \
        n_trials


def path_o6(path, run, n_trials: int, ranks: list, card: str) -> dict:
    """O6: ``--do_train --distributed --distributed_backend gloo
    --model_parallel 2`` run by the two ranks of O2-O5 on the default
    stack's keys with AAmSoftmax and sharded checkpoints, one epoch, then
    ``--do_infer --eval`` from its checkpoint in the same two ranks (the
    files split): against ``--do_infer --eval`` in this one process."""
    import contextlib
    import csv
    import io
    from speakerverification_tpu_torch.cli.main import main as cli_main
    from speakerverification_tpu_torch.training import (
        checkpoint_sharded as cs,
    )
    train, split_eval = ranks[0]["train"], ranks[0]["eval"]
    for line in train["out"].splitlines():
        if line.startswith(("[INFO]", "[E0", "[DONE]", "[WARN]")):
            log(f"[O6 train] {line}")
    bad = [(v, r[v]["rc"]) for r in ranks for v in ("train", "eval")
           if r[v]["rc"] != 0]
    log_meta = json.loads((run / "model" / "model_state_log.json")
                          .read_text())
    sharded = [n for n in ("best_state", "last_state")
               if cs.is_sharded_checkpoint(run / "model" / n)]
    if bad or len(sharded) != 2 or "x 2 model shards" not in train["out"]:
        fail(f"path O6: the ranks' CLI runs ended {bad}, left {sharded}")
    split = list(csv.reader((run / "result" /
                             "split_evaluation_results.csv").open()))
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--do_infer", "--eval", "--config", str(path),
                       *([] if O_DEVICE == "cuda" else ["--device",
                                                         O_DEVICE])])
    one_s = time.time() - t0
    result = run / "result" / "evaluation_results.csv"
    whole = list(csv.reader(result.open())) if rc == 0 else []
    same_rows = [(r[0], r[2]) for r in split] == [(r[0], r[2])
                                                  for r in whole]
    diff = max((abs(float(a[1]) - float(b[1]))
                for a, b in zip(split[1:], whole[1:])), default=float("inf"))
    ok = (rc == 0 and same_rows and len(whole) == n_trials + 1
          and diff <= O_BARS["cli_scores"])
    log(f"[O6] --do_train in the two ranks (data 1 x model 2, sharded "
        f"checkpoints {sharded}): {log_meta['step']} steps of "
        f"{2 * O_H['dataloader_options']['batch_size']} crops, "
        f"{train['s']:.1f} s; --do_infer --eval split over them "
        f"{split_eval['s']:.1f} s, in one process {one_s:.1f} s: "
        f"{len(whole) - 1} trials, the same trials and labels {same_rows}, "
        f"scores bit for bit {diff == 0.0}, max |diff| {diff:.2e} (bar "
        f"{O_BARS['cli_scores']:g}) ({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path O6: the split evaluation differs from one process's")
    return {"train_s": train["s"], "eval_s": split_eval["s"],
            "one_s": one_s, "diff": diff}


def path_o(tmp, card: str) -> dict:
    """Path O: O1-O6, the launches counted from 0 over all of them (the
    ranks' own counts added)."""
    t_all = time.time()
    reset_counts()
    walls = {}
    t0 = time.time()
    o1 = path_o1(tmp, card)
    walls["O1"] = time.time() - t0
    t0 = time.time()
    ranks = path_o_ranks(tmp, card)
    walls["O2,O3,O5,O6"] = time.time() - t0
    t0 = time.time()
    o4 = path_o4(card)
    walls["O4"] = time.time() - t0
    here = read_counts()
    counts = {k: here[k] + ranks["counts"][k] for k in KERNELS}
    log(f"[O] launches over O1-O6 (the ranks' included): {counts}; wall "
        f"{time.time() - t_all:.1f} s by phase "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} ({card})")
    if O_DEVICE == "cuda" and not (counts["mel_frontend"] >= 1
                                   and counts["res2net_cascade"] >= 1):
        fail(f"path O: K1 or K2 never launched ({counts})")
    return {"counts": counts, "o1": o1, "o4": o4, "o5": ranks["o5"],
            "o6": ranks["o6"]}


def multi_gpu() -> None:
    """Path O alone, after the kernels' build: the quick check of the
    multi-GPU slice."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_multi_"))
    try:
        out = path_o(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[O] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


# ----------------------------------------------------------------------
# F2's fp32 convolution gradient: remedies side by side (--f2-conv)
# ----------------------------------------------------------------------
# each in a process of its own: cuDNN's algorithm cache, its workspace
# cap (read once) and the peak memory are per process. A "cached" ("big")
# run first leaves a 66 (76) GiB block free in PyTorch's allocator, as
# the phases before F2 may: without a timed pick, cuDNN may take a plan
# whose workspace fits in the free memory. All but the benchmark runs
# turn the train step's timed pick (timed_conv_plans) off
F2_CONV_VARIANTS = {"default": {}, "benchmark": {},
                    "wscap": {"CUDNN_CONV_WSCAP_DBG": "1024"}, "gemm": {},
                    "default cached": {}, "benchmark cached": {},
                    "wscap cached": {"CUDNN_CONV_WSCAP_DBG": "1024"},
                    "gemm cached": {}, "default big": {},
                    "benchmark big": {}}
F2_FREE_GIB = {"cached": 66, "big": 76}


def _gemm_same_conv(cin: int, cout: int, bias: bool):
    """A 3-tap 'SAME' conv computed as one product over the three shifted
    copies of its input (im2col), so that its gradients are products."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class GemmConv1d(nn.Conv1d):
        def forward(self, x):
            t = x.shape[-1]
            xp = F.pad(x, (1, 1))
            cols = torch.cat([xp[:, :, i:i + t] for i in range(3)], dim=1)
            w = self.weight.permute(0, 2, 1).reshape(self.out_channels, -1)
            out = torch.matmul(w, cols)
            return out if self.bias is None else out + self.bias[:, None]
    return GemmConv1d(cin, cout, 3, padding=1, bias=bias)


def f2_conv_variant(variant: str) -> None:
    """F2's train step (64 crops, AAmSoftmaxAP, AdaBelief) timed and
    profiled with one remedy for its FFT convolution gradient: fp32, and
    bf16 but for the GEMM form."""
    import torch
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = variant.startswith("benchmark")
    if not variant.startswith("benchmark"):
        from speakerverification_tpu_torch.training import train_step
        train_step.timed_conv_plans = lambda device: contextlib.nullcontext()
    gib = F2_FREE_GIB.get(variant.split()[-1])
    if gib:
        block = torch.empty(gib * 2**30, dtype=torch.uint8, device="cuda")
        del block
    if variant.startswith("gemm"):
        from speakerverification_tpu_torch.models import rawnet_blocks
        rawnet_blocks._same_conv = _gemm_same_conv
    time_steps("fp32", RAW_ECAPA_HPARAMS, card, tag=f"F2 {variant}")
    if not variant.startswith("gemm"):
        time_steps("bf16 mixedprec", {**RAW_ECAPA_HPARAMS, "mixedprec": True},
                   card, tag=f"F2 {variant}")


def f2_conv() -> None:
    """Run :func:`f2_conv_variant` for each remedy in its own process
    (kernels built once, here)."""
    import os
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    build_kernels()
    only = sys.argv[2:]
    for variant, env in F2_CONV_VARIANTS.items():
        if only and variant not in only:
            continue
        t0 = time.time()
        out = subprocess.run([sys.executable, __file__, "--f2-conv-variant",
                              *variant.split()], env={**os.environ, **env},
                             capture_output=True, text=True, timeout=600)
        log(out.stdout.rstrip())
        if out.returncode != 0:
            fail(f"--f2-conv {variant}: {out.stderr[-2000:]}")
        log(f"[F2 {variant}] process took {time.time() - t0:.1f} s")


def forwards() -> None:
    """Paths A, B and F1's serving forwards alone (random weights from the
    seed, random BN), each timed by CUDA events, so that two trees can be
    compared in one call: a copy of this file run from each tree's root
    imports that tree's package."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    pallas_b = {**ECAPA_TDNN_HPARAMS, "model": {
        **ECAPA_TDNN_HPARAMS["model"], "conv_backend": "pallas"}}
    for label, h, seed in (("A Raw3_ECAPA", RAW3_ECAPA_HPARAMS, 1),
                           ("B ECAPA_TDNN 1024", pallas_b, 3),
                           ("F1 Raw_ECAPA_conv_asp", RAW_ECAPA_HPARAMS, 5)):
        engine = InferenceEngine(h)
        randomize_bn_(engine.model, seed=seed)
        spec = h["audio_spec"]
        waves = (0.1 * np.random.default_rng(seed).normal(0, 1, (
            BATCH_UTTS * h["num_eval"],
            int(spec["sentence_len"] * spec["sample_rate"])))).astype(
                np.float32)
        throughput(label, engine, waves, h["num_eval"], card)
        del engine


def conformer() -> None:
    """Path I alone, after the kernels' build: the quick check of the
    Conformer family."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_conformer_"))
    try:
        out = path_i(tmp, card, dev, gen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[I] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


def zoo() -> None:
    """Path J alone, after the kernels' build: the quick check of the
    tenth slice."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_zoo_"))
    try:
        out = path_j(tmp, card, dev, gen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[J] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


def model_zoo() -> None:
    """Path M alone, after the kernels' build: the quick check of the
    twelfth slice."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = path_m(dev, gen, card)
    log(f"[M] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


def train_zoo() -> None:
    """Path L alone, after the kernels' build: the quick check of the
    eleventh slice."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_train_zoo_"))
    try:
        out = path_l(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[L] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


def data_path() -> None:
    """Path H alone, path G's corpora written first, after the kernels'
    build: the quick check of the data path."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_data_"))
    try:
        out = path_h(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[H] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


# ----------------------------------------------------------------------
# path P: reference torch checkpoints in and out, and a JAX orbax
# directory served (--checkpoints)
# ----------------------------------------------------------------------
# P1 builds a reference training checkpoint of the full-width Raw3_ECAPA
# (yaml/raw3_ecapa.yaml) from the committed key/shape manifest, which
# tests/test_torch_port_compat.py proves against the JAX porter; P3 serves
# the orbax fixture tests/data/make_orbax_fixture.py wrote through the JAX
# package (tests/test_torch_port_orbax.py rehearses P3 on the CPU).
P_MANIFEST = Path(__file__).resolve().parent / "tests" / "data" / \
    "raw3_ecapa.torch_shapes.json"
P_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / \
    "orbax_ecapa"
P_H = {**RAW3_ECAPA_HPARAMS, "model": {**RAW3_ECAPA_HPARAMS["model"],
                                       "conv_backend": "pallas"}}
P_SEED = 18


def p_reference_checkpoint(path, seed: int = P_SEED) -> dict:
    """A reference training checkpoint (``module.__S__.`` backbone,
    ``module.__L__.weight`` the ARmSoftmax head's centres) with the
    manifest's keys and shapes, filled from a seeded generator: weights
    scaled by their fan-in, norm scales near 1, running variances
    positive, the pre-emphasis filter its constant. Returns the state
    dict it saved."""
    import math

    import torch
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in json.loads(P_MANIFEST.read_text()).items():
        if k.endswith("num_batches_tracked"):
            v = torch.zeros(shape, dtype=torch.long)
        elif k.endswith("flipped_filter"):
            v = torch.tensor([-0.97, 1.0]).reshape(shape)
        elif k.endswith("running_var"):
            v = 0.5 + torch.rand(shape, generator=gen)
        elif len(shape) >= 2:
            v = torch.randn(shape, generator=gen) / math.sqrt(
                math.prod(shape[1:]))
        elif k.endswith(".weight"):
            v = 1 + 0.1 * torch.randn(shape, generator=gen)
        else:
            v = 0.1 * torch.randn(shape, generator=gen)
        sd[f"module.__S__.{k}"] = v
    n_classes = RAW3_TRAIN_HPARAMS["nClasses"]
    sd["module.__L__.weight"] = 0.05 * torch.randn(
        n_classes, RAW3_ECAPA_HPARAMS["model"]["nOut"], generator=gen)
    torch.save(sd, path)
    return sd


def p_cli(module: str, *args) -> str:
    run = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        fail(f"python -m {module} failed:\n{run.stdout}\n{run.stderr}")
    return run.stdout


def p_eval(h: dict, want: dict, label: str, batches: int) -> dict:
    """``--do_infer --eval`` (``inference(h, eval_=True)``) with the
    kernels' launches counted; returns the report and the counts."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import inference
    reset_counts()
    t0 = time.time()
    report = inference(h, eval_=True)["eval"]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    scores = read_scores(h)
    log(f"[{label}] --do_infer --eval of {len(scores)} trials ({batches} "
        f"batches): {wall:.2f} s wall; EER {report['eer']:.4f}%; launches "
        f"{counts}")
    if counts != want:
        fail(f"path {label}: expected launches {want}, got {counts}")
    if len(scores) != 40 or not np.isfinite(scores).all() or not all(
            np.isfinite(report[k]) for k in ("eer", "min_dcf", "auc")):
        fail(f"path {label}: report or scores not finite / incomplete")
    return {"counts": counts, "scores": scores}


def path_p1(tmp, card: str) -> dict:
    """A reference ``.pt`` of the full-width Raw3_ECAPA through the
    converter CLI, served on the card in fp32 (K1, K2) and int8 (K3)."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.compat.torch_port import (
        state_dict_from_reference,
    )
    from speakerverification_tpu_torch.inference import InferenceEngine

    t0 = time.time()
    ref = p_reference_checkpoint(tmp / "ref.pt")
    out = tmp / "raw3_ecapa.msgpack"
    said = p_cli("speakerverification_tpu_torch.compat.torch_port",
                 "--arch", "Raw3_ECAPA", "--input", tmp / "ref.pt",
                 "--output", out)
    log(f"[P1] converter CLI: {said.strip()} ({time.time() - t0:.1f} s with "
        "the reference checkpoint's write)")
    if "loss head ported" not in said:
        fail("path P1: the converter did not port the loss head")

    sr = P_H["audio_spec"]["sample_rate"]
    files, trials = write_trial_data(tmp, sr)
    batches = -(-len(files) // BATCH_UTTS)
    h = {**P_H, "eval_batch_size": BATCH_UTTS, "evaluation_file": trials,
         "save_folder": str(tmp / "save"), "initial_model_infer": str(out),
         "dataloader_options": {"num_workers": 4}}
    fp32 = p_eval(h, {"mel_frontend": batches, "res2net_cascade":
                      3 * batches, "quant_matmul": 0}, "P1 fp32", batches)
    # the first int8 batch also runs the float model once, on the rows
    # that calibrate the static scales
    int8 = p_eval({**h, "quant": "int8"},
                  {"mel_frontend": batches + 1,
                   "res2net_cascade": 3 * (batches + 1),
                   "quant_matmul": 22 * batches}, "P1 int8", batches)
    diff = np.abs(int8["scores"] - fp32["scores"])
    log(f"[P1] per-trial |int8 - fp32| score: max {diff.max():.3e}")

    engine = InferenceEngine(h)
    want = state_dict_from_reference(
        {k: v for k, v in ref.items()}, "Raw3_ECAPA")
    got = engine.model.backbone.state_dict()
    if sorted(got) != sorted(want) or not all(
            torch.equal(got[k].cpu(), want[k]) for k in want):
        fail("path P1: the served weights are not the converted reference")
    n = BATCH_UTTS * P_H["num_eval"]
    samples = int(P_H["audio_spec"]["sentence_len"] * sr)
    waves = (0.1 * np.random.default_rng(8).normal(0, 1, (n, samples))
             ).astype(np.float32)
    compare_with_cpu(engine, waves[:16], "P1")
    ms = cuda_ms(lambda: engine.embed_fn(waves), iters=10, warmup=2)
    int8_engine = InferenceEngine({**h, "quant": "int8"})
    int8_engine.embed_fn(waves)                      # calibrates
    ms8 = cuda_ms(lambda: int8_engine.embed_fn(waves), iters=10, warmup=2)
    log(f"[P1 timing] converted Raw3_ECAPA, {n} crops of {samples} samples "
        f"a batch: fp32 {ms:.2f} ms, int8 {ms8:.2f} ms ({card})")
    counts = {k: fp32["counts"][k] + int8["counts"][k] for k in KERNELS}
    return {"counts": counts, "msgpack": out, "ref": ref, "ms": ms,
            "ms_int8": ms8}


def path_p2(tmp, p1: dict) -> None:
    """The reverse CLI on P1's msgpack with the converter's manifest gives
    back the reference's stripped backbone and head, bit for bit."""
    import torch
    t0 = time.time()
    back = tmp / "state_dict.pt"
    said = p_cli("speakerverification_tpu_torch.compat.torch_export",
                 "--arch", "Raw3_ECAPA", "--input", p1["msgpack"],
                 "--shapes", str(p1["msgpack"]) + ".torch_shapes.json",
                 "--output", back)
    sd = torch.load(back, weights_only=True)
    want = {k.removeprefix("module.").removeprefix("__S__."): v
            for k, v in p1["ref"].items()}
    bad = sorted(set(sd) ^ set(want)) or [
        k for k in want if sd[k].dtype != want[k].dtype
        or not torch.equal(sd[k], want[k])]
    log(f"[P2] reverse CLI: {said.strip()}; {len(sd)} keys, "
        f"{'bit for bit' if not bad else 'MISMATCH'} "
        f"({time.time() - t0:.1f} s)")
    if bad:
        fail(f"path P2: the reverse port differs at {bad[:5]}")


def path_p3(card: str) -> dict:
    """The JAX package's orbax fixture served by the port's engine on the
    card (K1, K2), at cosine >= 0.9999 to JAX's stored embeddings; the
    zstd decoder's rate on the fixture's frames."""
    import numpy as np
    import torch
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.training import orbax_read

    fx = json.loads((P_FIXTURE / "fixture.json").read_text())
    h = {**ECAPA_TDNN_HPARAMS, "seed": fx["seed"],
         "initial_model_infer": str(P_FIXTURE / "state"),
         "model": {**fx["model"], "feature_type": "melspectrogram",
                   "conv_backend": "pallas"}}
    t0 = time.time()
    engine = InferenceEngine(h)
    load_s = time.time() - t0
    rng = np.random.default_rng(fx["wave_seed"])
    waves = (0.1 * rng.standard_normal(fx["wave_shape"])).astype(np.float32)
    reset_counts()
    got = engine.embed_fn(waves).cpu().numpy()
    counts = read_counts()
    ref = np.load(P_FIXTURE / "embeddings.npy")
    cos = cosines(got, ref)
    ok = bool(np.isfinite(got).all()) and cos.min() >= 0.9999
    log(f"[P3] orbax fixture served on the card ({load_s:.2f} s to build "
        f"and load): min cos {cos.min():.7f} to JAX's embeddings (need >= "
        f"0.9999) {'ok' if ok else 'FAIL'}; launches {counts}")
    if not ok:
        fail("path P3: the served orbax state disagrees with JAX")
    if counts != {"mel_frontend": 1, "res2net_cascade": 3,
                  "quant_matmul": 0}:
        fail(f"path P3: expected 1 mel and 3 cascade launches, got {counts}")

    store = orbax_read.OcdbtStore(P_FIXTURE / "state")
    frames = [store[k] for k in store.keys() if not k.endswith(b".zarray")]
    store.close()
    stated = sum(orbax_read.zstd_content_size(f) is not None for f in frames)
    # the reader decodes each chunk in place at the size its .zarray gives
    sizes = [len(orbax_read.zstd_decompress(f)) for f in frames]
    decoded = sum(sizes)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        for f, n in zip(frames, sizes):
            orbax_read.zstd_decompress(f, n)
    dt = time.perf_counter() - t0
    rate = decoded * reps / dt / 1e6
    t0 = time.perf_counter()
    orbax_read.read_orbax(P_FIXTURE / "state")
    read_s = time.perf_counter() - t0
    log(f"[P3 timing] zstd decoder: {len(frames)} frames ({decoded:,} bytes "
        f"decoded, {len(frames) - stated} without a content size) "
        f"at {rate:.1f} MB/s over {reps} passes; whole read_orbax "
        f"{read_s * 1e3:.1f} ms (host CPU; {card})")
    return {"counts": counts, "zstd_mb_s": rate}


def path_p(tmp, card: str) -> dict:
    t0 = time.time()
    p1 = path_p1(tmp, card)
    path_p2(tmp, p1)
    p3 = path_p3(card)
    counts = {k: p1["counts"][k] + p3["counts"][k] for k in KERNELS}
    log(f"[P] reference checkpoints and the orbax fixture: {time.time() - t0:.1f}"
        f" s; launches {counts}")
    return {"counts": counts}


def checkpoints() -> None:
    """Path P alone, after the kernels' build: the quick check of the
    checkpoint converters and the orbax reader."""
    import shutil
    import tempfile

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_checkpoints_"))
    try:
        out = path_p(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[P] passed in {time.time() - T_START:.1f} s; launches "
        f"{out['counts']} ({card})")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        import speakerverification_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port package is not importable here: {exc}")
    card = card_line()
    log(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    # parity configuration: full fp32 products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    global PROFILE_STEPS, LOADER_BATCHES, L2_STEPS, L3_STEPS, L3_UPDATES
    global TIMED_STEPS_CAP, C_LIST_SHARE
    # the whole script's depth cuts, which keep it under 1,000 s on the
    # slower H100 hosts with paths O and P (1,083 s on one without the
    # last three)
    PROFILE_STEPS, LOADER_BATCHES = False, 8
    L2_STEPS, L3_STEPS, L3_UPDATES = 6, 2, 2
    TIMED_STEPS_CAP, C_LIST_SHARE = 2, 0.25
    t_start = time.time()
    marks = [("start", t_start)]

    def mark(name):
        marks.append((name, time.time()))

    build_kernels()
    k1 = check_mel_kernel(dev, gen)
    k2 = check_cascade_kernel(dev, gen)
    k3 = check_quant_kernel(dev, gen)
    per_forward_k3(k3)
    for r in k1 + k2 + k3:
        log("[timing] " + json.dumps({**r, "card": card}))
    mark("kernels")

    a = path_a(card)
    b = path_b()
    import shutil
    import tempfile
    from pathlib import Path
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_eval_"))
    try:
        c = path_c(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import numpy as np
    waves_a = np.clip(np.round(0.3 * np.random.default_rng(5).normal(
        0, 1, (a["n_crops"], a["samples"])) * 32768), -32768,
        32767).astype(np.int16)
    throughput("A Raw3_ECAPA int16 wire", a["engine"], waves_a,
               RAW3_ECAPA_HPARAMS["num_eval"], card)
    throughput("B ECAPA_TDNN 1024", b["engine"], b["waves"],
               ECAPA_TDNN_HPARAMS["num_eval"], card)
    throughput("C Raw3_ECAPA int8, eval batch", c["engine"], c["waves"],
               RAW3_ECAPA_HPARAMS["num_eval"], card)
    profile("A", a["engine"], waves_a)
    profile("B", b["engine"], b["waves"])
    profile("C", c["engine"], c["waves"])
    path_c_bf16(c, card)
    mark("A-C")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_banks_"))
    try:
        d = path_d(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("D")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_train_"))
    try:
        e = path_e(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("E")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_rawnet2_"))
    try:
        f = path_f(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("F")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_augment_"))
    try:
        g = path_g(tmp, card)
        mark("G")
        h = path_h(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("H")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_conformer_"))
    try:
        i = path_i(tmp, card, dev, gen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("I")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_zoo_"))
    try:
        j = path_j(tmp, card, dev, gen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("J")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_train_zoo_"))
    try:
        l_ = path_l(tmp, card, **L_SHAMPOO_WHOLE_RUN)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("L")
    m = path_m(dev, gen, card)
    mark("M")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_export_"))
    try:
        n = path_n(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("N")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_multi_"))
    try:
        o = path_o(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("O")
    tmp = Path(tempfile.mkdtemp(prefix="svtorch_checkpoints_"))
    try:
        p_ = path_p(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("P")
    log("[wall by path] " + json.dumps(
        {n: round(t - t0, 1) for (_, t0), (n, t) in zip(marks, marks[1:])}))
    paths = {"A": a["counts"], "B": b["counts"], "C": c["counts"],
             "D": d["counts"], "E": e["counts"], "F": f["counts"],
             "G": g["counts"], "H": h["counts"], "I": i["counts"],
             "J": j["counts"], "L": l_["counts"], "M": m["counts"],
             "N": n["counts"], "O": o["counts"], "P": p_["counts"]}
    by_path = {k: {p: counts[k] for p, counts in paths.items()}
               for k in KERNELS}

    # each kernel's row at its main paths' shapes (K1: path A's and path
    # F's serving and train shapes, which I1 and I5 serve at, paths E's,
    # G's and I's train steps; K3: path C's hot conv shape and the
    # Conformer's Dense shape with the most time per forward)
    conformer_k3 = [r for r, (_, _, _, layer) in zip(
        i["k3"], [s for s in CONFORMER_DENSE_SHAPES for _ in (0, 1)])
        if layer.startswith("Conformer ") and r["shape"].endswith("float32")]
    hot_dense = max(conformer_k3,
                    key=lambda r: r["ms"] * r["launches_per_forward"])
    # K3's new shape with the most time per forward on path J (fp32)
    hot_zoo = max((r for r in j["k3"] if r["shape"].endswith("float32")),
                  key=lambda r: r["ms"] * r["launches_per_forward"])
    # and on path M
    hot_m = max((r for r in m["k3"] if r["shape"].endswith("float32")),
                key=lambda r: r["ms"] * r["launches_per_forward"])
    main_shapes = {"mel_frontend": ("raw3_ecapa 8k", "raw_ecapa 16k",
                                    "raw_ecapa 16k train",
                                    "raw3_ecapa 8k train",
                                    "ecapa_tdnn 16k train",
                                    "model_plot 16k train"),
                   "res2net_cascade": ("H128 B80 d2 float32",
                                       "H128 B160 d2 float32"),
                   "quant_matmul": (HOT_QUANT, hot_dense["shape"],
                                    hot_zoo["shape"], hot_m["shape"])}
    meta = {
        "mel_frontend": ("speakerverification_tpu_torch/csrc/mel_frontend.cu",
                         "speakerverification_tpu/ops/pallas_frontend.py:68"),
        "res2net_cascade": (
            "speakerverification_tpu_torch/csrc/res2net_cascade.cu",
            "speakerverification_tpu/ops/pallas_res2net.py:64"),
        "quant_matmul": ("speakerverification_tpu_torch/csrc/quant_matmul.cu",
                         "speakerverification_tpu/ops/pallas_quant.py:42"),
    }
    kernels, seen = [], set()
    for r in k1 + k2 + k3 + i["k3"] + j["k3"] + m["k2"] + m["k3"]:
        if r["shape"] not in main_shapes[r["name"]] \
                or (r["name"], r["shape"]) in seen:
            continue
        seen.add((r["name"], r["shape"]))
        src, repl = meta[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": repl, "launches": sum(by_path[r["name"]].values()),
            "launches_by_path": by_path[r["name"]],
            "shape": r["shape"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    jaxish = [m for m in sys.modules if m in ("jax", "speakerverification_tpu")
              or m.startswith(("jax.", "speakerverification_tpu."))]
    if jaxish:
        fail(f"JAX or the JAX package was imported: {jaxish[:5]}")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(card, flush=True)
    print(f"[wall] {time.time() - T_START:.1f} s for the whole script",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--f2-conv"]:
        f2_conv()
    elif sys.argv[1:2] == ["--f2-conv-variant"]:
        f2_conv_variant(" ".join(sys.argv[2:]))
    elif sys.argv[1:2] == ["--forwards"]:
        forwards()
    elif sys.argv[1:2] == ["--data-path"]:
        data_path()
    elif sys.argv[1:2] == ["--conformer"]:
        conformer()
    elif sys.argv[1:2] == ["--zoo"]:
        zoo()
    elif sys.argv[1:2] == ["--train-zoo"]:
        train_zoo()
    elif sys.argv[1:2] == ["--model-zoo"]:
        model_zoo()
    elif sys.argv[1:2] == ["--export-tools"]:
        export_tools()
    elif sys.argv[1:2] == ["--multi-gpu"]:
        multi_gpu()
    elif sys.argv[1:2] == ["--checkpoints"]:
        checkpoints()
    elif sys.argv[1:2] == ["--o-rank"]:
        o_rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
