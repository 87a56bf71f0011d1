"""Training with augmentation (CPU, a small ECAPA_TDNN on synthetic WAVs
and a synthetic noise corpus).

* The train step with ``augment_fn``: JAX's step runs
  ``device_env_corrupt`` under its step key; the port's runs
  ``apply_env_corrupt`` on JAX's draws, replayed. Each port step starts
  from the JAX step's incoming state (through a JAX-written checkpoint)
  and is held to the bars of ``test_torch_port_train_step.py``: loss
  1e-5 relative, batch statistics 1e-5, the update within 3e-2 of JAX's
  in norm with cosine ≥ 0.9995; at ``accum_steps`` 1 and 2 (the batch is
  augmented whole, before the split, in both).
* The Trainer end to end with ``device_augment``, ``device_time_augment``
  and ``spec_domain``: banks built, refreshed in epoch 2 from
  ``seed * 7919 + 2``, the loader's engine detached, the step handed the
  banks and the epoch's generator.
* ``--do_train --augment`` through the CLI with the host chain
  (``env_corrupt`` and ``time_domain``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.data.augment import AugmentWav as JAugmentWav
from speakerverification_tpu.ops import device_augment as jda
from speakerverification_tpu.training.train_step import (
    make_train_step as j_make_train_step,
)
from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.data.manifest import generate_metadata
from speakerverification_tpu_torch.ops import device_augment as tda
from speakerverification_tpu_torch.training import trainer as ttrainer
from speakerverification_tpu_torch.training.train_step import (
    make_train_step as t_make_train_step,
)

from test_torch_port_augment_helpers import SPEC, env_draw, write_noise_corpus
from test_torch_port_train_helpers import (
    Pair,
    batches,
    flat,
    rel_errors,
    update_cosines,
)

LR = 1e-3
SR = 8000
ZERO_GRAD = ("AttentiveStatisticsPooling_0/Conv1d_0/Conv_0/bias",)
H = {"seed": 0, "audio_spec": SPEC, "features": "melspectrogram",
     "n_mels": 80,
     "model": {"name": "ECAPA_TDNN", "nOut": 16,
               "channels": [32, 32, 32, 32, 96], "attention_channels": 8,
               "se_channels": 8, "res2net_scale": 4},
     "criterion": {"name": "AAmSoftmax", "margin": 0.2, "scale": 30},
     "nClasses": 6, "lr": LR, "optimizer": {"name": "adam"}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_noise")
    return write_noise_corpus(root)


@pytest.mark.parametrize("accum", [1, 2])
def test_step_with_augment_fn_matches_jax(corpus, accum, tmp_path):
    torch.set_num_threads(2)
    jbanks = jda.build_banks(JAugmentWav(corpus, SPEC), n_noise=8, n_rir=4,
                             rng=np.random.default_rng(1))
    tbanks = tda.banks_from_arrays(jbanks, device="cpu")
    data = batches(np.random.default_rng(0), 2, 4, 2, 4000, 6)
    pair = Pair(H, data[0], accum_steps=accum)
    jstep = jax.jit(j_make_train_step(
        pair.jmodel, pair.jtx, accum_steps=accum,
        augment_fn=lambda w, r, banks: jda.device_env_corrupt(w, banks, r)))
    replay = {}
    tstep = t_make_train_step(
        pair.tmodel, pair.ttx, accum_steps=accum,
        augment_fn=lambda w, gen, banks: tda.apply_env_corrupt(
            w, replay["draw"], banks))
    gen = torch.Generator().manual_seed(0)
    before = flat(pair.jstate.params)
    for i, (wave, label) in enumerate(data):
        pair.load_jax_state(tmp_path)
        key = jax.random.PRNGKey(i)
        replay["draw"] = env_draw(jax.random.fold_in(key, 2), 8, jbanks)
        pair.jstate, jm = jstep(pair.jstate, jnp.asarray(wave),
                                jnp.asarray(label), key, jnp.float32(LR),
                                jbanks)
        pair.tstate, tm = tstep(pair.tstate, torch.from_numpy(wave),
                                torch.from_numpy(label), LR, gen, tbanks)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(jl - tl) <= 1e-5 * abs(jl), (i, jl, tl)
        tp, ts = pair.port_trees()
        stats = rel_errors(ts, flat(pair.jstate.batch_stats))
        assert max(stats.values()) <= 1e-5, i
        ref = flat(pair.jstate.params)
        keep = [k for k in ref if not "/".join(k).endswith(ZERO_GRAD)]
        got = np.concatenate([(tp[k] - before[k]).ravel() for k in keep])
        want = np.concatenate([(ref[k] - before[k]).ravel() for k in keep])
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        cos, _ = update_cosines(tp, before, ref, ZERO_GRAD)
        assert err <= 3e-2 and cos >= 0.9995, (i, err, cos)
        before = ref
    # the augmentation changed what the model saw
    assert not bool((replay["draw"].augtype == 3).all())


def test_step_with_augment_fn_needs_a_generator():
    pair = Pair(H, batches(np.random.default_rng(0), 1, 4, 2, 4000, 6)[0])
    step = t_make_train_step(pair.tmodel, pair.ttx,
                             augment_fn=lambda w, gen: w)
    wave = torch.zeros(4, 2, 4000)
    with pytest.raises(ValueError, match="generator"):
        step(pair.tstate, wave, torch.arange(4), LR)


def _train_corpus(root, n_spk=6, n_utt=6):
    rng = np.random.default_rng(0)
    for spk in range(n_spk):
        for utt in range(n_utt):
            tt = np.arange(int(0.8 * SR)) / SR
            sig = (0.3 * np.sin(2 * np.pi * (120 + 60 * spk) * tt
                                + rng.uniform(0, 6))
                   + rng.normal(0, 0.01, tt.size))
            write_wav(root / "data" / f"spk{spk}" / f"u{utt}.wav",
                      sig.astype(np.float32), SR)
    generate_metadata(root / "data", root / "meta", split_ratio=-1, seed=0)


def _hparams(root, opts, **extra):
    return {"seed": 3, "save_folder": str(root / "save"),
            "train_annotation": str(root / "meta" / "train.csv"),
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                      "nOut": 16, "channels": [16, 16, 16, 16, 48],
                      "attention_channels": 4, "res2net_scale": 2,
                      "se_channels": 4},
            "nClasses": 6, "lr": 0.003, "number_of_epochs": 2,
            "criterion": {"name": "ARmSoftmax", "margin": 0.2, "scale": 30},
            "optimizer": {"name": "adam"},
            "dataloader_options": {"batch_size": 3, "nPerSpeaker": 2,
                                   "num_workers": 2},
            "augment": True, "augment_options": opts, **extra}


def test_trainer_with_device_augmentation(corpus, tmp_path, monkeypatch):
    torch.set_num_threads(2)
    _train_corpus(tmp_path)
    opts = {**corpus, "augment_chain": ["env_corrupt", "spec_domain"]}
    h = _hparams(tmp_path, opts, device_augment=True,
                 device_time_augment=True, device_augment_noise_bank=6,
                 device_augment_rir_bank=3)
    builds = []
    real = ttrainer.build_banks

    def counted(*a, rng=None, **kw):
        builds.append(None if rng is None else rng.bit_generator.state)
        return real(*a, rng=rng, **kw)
    monkeypatch.setattr(ttrainer, "build_banks", counted)
    tr = ttrainer.Trainer(h, device="cpu")
    assert tr.loader.augmentor is None and tr._aug_banks.noise.shape == (
        6, 4000)
    assert tr.model.spec_augment is not None
    seen = []
    step = tr.step_fn

    def spy(state, wave, label, lr, rng, *aug):
        seen.append((rng, aug))
        return step(state, wave, label, lr, rng, *aug)
    tr.step_fn = spy
    result = tr.fit()
    assert np.isfinite(result["min_loss"])
    scores = (tmp_path / "save" / "ECAPA_TDNN" / "ARmSoftmax" / "result"
              / "scores.txt").read_text().splitlines()
    assert len(scores) == 2
    # the first build is unseeded (as the JAX trainer's), epoch 2's is
    # seeded from seed * 7919 + 2
    assert builds[0] is None and len(builds) == 2
    assert builds[1] == np.random.default_rng(3 * 7919 + 2).bit_generator.state
    assert all(rng is tr.rng and len(aug) == 1 for rng, aug in seen)
    assert seen[-1][1][0] is tr._aug_banks


@pytest.mark.parametrize("mode", ["np", "torch"])
def test_device_time_augment_without_env_corrupt_files(tmp_path, mode):
    """``device_time_augment`` alone, with no noise files: the chain runs
    without banks."""
    _train_corpus(tmp_path)
    h = _hparams(tmp_path, {"augment_paths": {}, "augment_chain": []},
                 device_time_augment=mode, number_of_epochs=1)
    tr = ttrainer.Trainer(h, device="cpu")
    assert tr._aug_banks is None and tr._augment_fn is not None
    assert np.isfinite(tr.fit()["min_loss"])


def test_cli_trains_with_augment(corpus, tmp_path, capsys):
    """``--augment`` turns on the yaml's chain: env_corrupt and
    time_domain on the loader's threads."""
    _train_corpus(tmp_path)
    h = _hparams(tmp_path, corpus, augment=False, number_of_epochs=1)
    cfg = tmp_path / "c.yaml"
    import json
    cfg.write_text(json.dumps(h))
    assert cli_main(["--do_train", "--augment", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    assert "[DONE] min_loss" in capsys.readouterr().out
    frozen = (tmp_path / "save" / "ECAPA_TDNN" / "ARmSoftmax" / "config"
              / "config_frozen.yaml").read_text()
    assert "augment: true" in frozen


def test_chip_smoke_augment_keys_mirror_the_yamls():
    """Path G's augment_options (all but the folders) and ECAPA_TDNN's
    training keys are those of ``yaml/raw3_ecapa.yaml`` and
    ``yaml/ecapa_tdnn.yaml``."""
    import importlib.util
    from pathlib import Path

    from speakerverification_tpu.config import read_config

    from test_torch_port_serving import _subset_of
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, sub in (("raw3_ecapa.yaml",
                       {"augment_options": smoke.RAW3_AUGMENT}),
                      ("ecapa_tdnn.yaml",
                       {"augment_options": smoke.ECAPA_AUGMENT}),
                      ("ecapa_tdnn.yaml", smoke.ECAPA_TRAIN_HPARAMS)):
        _subset_of(sub, read_config(root / "yaml" / name), f"{name}: ")
