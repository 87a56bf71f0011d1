"""Training checkpoints across the two packages, the Trainer and the
``--do_train`` verb (CPU, a small ECAPA_TDNN on synthetic WAVs).

* The port trains 2 steps and saves; the JAX package's
  ``training.checkpoint.load_checkpoint`` restores the file as its full
  train state (optimizer and EMA included) and writes it back byte for
  byte; JAX's step 3 from it matches the port's step 3.
* A full state the JAX trainer writes resumes in the port's ``Trainer``
  (the whole state, not the weights only).
* ``--do_train`` then ``--do_infer --eval`` through the port's CLI.
* What the port does not take is refused by name.
"""

import json
import signal
import textwrap

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu.training import checkpoint as jckpt
from speakerverification_tpu.training.trainer import Trainer as JTrainer
from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.data.manifest import generate_metadata
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.training.trainer import Trainer

from test_torch_port_train_helpers import (
    Pair,
    batches,
    flat,
    rel_errors,
    update_cosines,
)

SR = 8000
SMALL = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram", "nOut": 16,
         "channels": [16, 16, 16, 16, 48], "kernel_sizes": [5, 3, 3, 3, 1],
         "dilations": [1, 2, 3, 4, 1], "attention_channels": 4,
         "res2net_scale": 2, "se_channels": 4}
ZERO_GRAD = ("AttentiveStatisticsPooling_0/Conv1d_0/Conv_0/bias",)


def _hparams(root, **extra):
    return {"seed": 3, "save_folder": str(root / "save"),
            "data_folder": str(root / "data"),
            "train_annotation": str(root / "meta" / "train.csv"),
            "valid_annotation": str(root / "meta" / "dev.csv"),
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "model": dict(SMALL), "nClasses": 6, "lr": 0.003,
            "number_of_epochs": 1, "batch_size": 3, "num_eval": 2,
            "criterion": {"name": "ARmSoftmax", "margin": 0.2, "scale": 30},
            "optimizer": {"name": "AdaBelief", "weight_decay": 2e-5,
                          "lr_decay": 0.95, "ema_decay": 0.99},
            "callbacks": {"name": "cosine_annealinglr_pt", "base_lr": 1e-8},
            "dataloader_options": {"batch_size": 3, "nPerSpeaker": 2,
                                   "max_seg_per_spk": 500, "num_workers": 2},
            **extra}


def _corpus(root, n_spk=6, n_utt=5):
    rng = np.random.default_rng(0)
    files = {}
    for spk in range(n_spk):
        for utt in range(n_utt):
            tt = np.arange(int(1.2 * SR)) / SR
            f0 = 120 + 70 * spk
            sig = sum(0.25 / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * tt
                                              + rng.uniform(0, 6))
                      for k in range(3)) + rng.normal(0, 0.01, tt.size)
            path = root / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), SR)
            files.setdefault(spk, []).append(str(path))
    return files


def _same_leaves(got, want) -> None:
    got, want = flatten_dict(got), flatten_dict(want)
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_port_checkpoint_restores_as_a_full_jax_state(tmp_path):
    torch.set_num_threads(2)
    h = _hparams(tmp_path)
    data = batches(np.random.default_rng(0), 3, 3, 2, 4000, 6)
    pair = Pair(h, data[0])
    pair.load_jax_state(tmp_path)                # the JAX init, both sides
    for wave, label in data[:2]:
        pair.tstate, _ = pair.tstep(pair.tstate, torch.from_numpy(wave),
                                    torch.from_numpy(label), 0.003)
    mgr = tckpt.CheckpointManager(tmp_path / "run")
    mgr.save_epoch(pair.tstate, 1, loss=3.0, lr=0.003)
    path = tmp_path / "run" / "best_state.msgpack"
    assert json.loads((tmp_path / "run" / "best_state.msgpack.json")
                      .read_text())["step"] == 2

    restored = jckpt.load_checkpoint(path, pair.jstate)
    assert int(restored.step) == 2
    # the whole state, optimizer and EMA included, round-trips through
    # JAX's own serializer to the same leaves (keys may come in another
    # order)
    _same_leaves(fser.msgpack_restore(fser.to_bytes(restored)),
                 fser.msgpack_restore(path.read_bytes()))
    assert int(restored.opt_state[0].count) == 2
    assert int(restored.opt_state[0].inner_state.count) == 2

    # JAX's step 3 from the port's state, against the port's step 3
    before = flat(restored.params)
    jstate, jm = pair.jstep(restored, jnp.asarray(data[2][0]),
                            jnp.asarray(data[2][1]), jax.random.PRNGKey(2),
                            jnp.float32(0.003))
    pair.tstate, tm = pair.tstep(pair.tstate, torch.from_numpy(data[2][0]),
                                 torch.from_numpy(data[2][1]), 0.003)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    tp, ts = pair.port_trees()
    assert max(rel_errors(ts, flat(jstate.batch_stats)).values()) <= 1e-5
    cos, _ = update_cosines(tp, before, flat(jstate.params), ZERO_GRAD)
    assert cos >= 0.9995


def test_jax_written_state_resumes_in_the_port_trainer(tmp_path, capsys):
    torch.set_num_threads(2)
    _corpus(tmp_path)
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    h = _hparams(tmp_path)
    JTrainer(h).fit()                      # writes last_state, best_state
    last = tmp_path / "save" / "ECAPA_TDNN" / "ARmSoftmax" / "model" / \
        "last_state.msgpack"
    raw = tckpt.codec.load_checkpoint(last)
    capsys.readouterr()

    trainer = Trainer({**h, "number_of_epochs": 2}, device="cpu")
    trainer._init_state()
    out = capsys.readouterr().out
    assert "incompatible" not in out and "resumed from" in out
    assert trainer.init_epoch == 2
    assert trainer.state.step == int(raw["step"]) > 0
    # weights, statistics and optimizer state as JAX wrote them
    state = tckpt.state_to_jax(trainer.state)
    _same_leaves(fser.msgpack_restore(tckpt.codec.msgpack_serialize(state)),
                 fser.msgpack_restore(last.read_bytes()))

    result = Trainer({**h, "number_of_epochs": 2}, device="cpu").fit()
    assert np.isfinite(result["min_loss"])
    scores = (tmp_path / "save" / "ECAPA_TDNN" / "ARmSoftmax" / "result" /
              "scores.txt").read_text().splitlines()
    assert scores[-1].startswith("epoch 2, LR ")


def _yaml(root, trials) -> str:
    return textwrap.dedent(f"""\
        seed: 3
        save_folder: {root}/save
        data_folder: {root}/data
        train_annotation: {root}/meta/train.csv
        valid_annotation: {root}/meta/dev.csv
        evaluation_file: {trials}
        number_of_epochs: 2
        batch_size: 3
        lr: 0.003
        test_interval: 1
        nClasses: 99
        num_eval: 2
        eval_batch_size: 4
        audio_spec: {{sample_rate: {SR}, channels: 1, sentence_len: 0.5,
                      win_len: 0.025, hop_len: 0.01}}
        n_mels: 40
        features: melspectrogram
        model: {json.dumps(SMALL)}
        criterion: {{name: ARmSoftmax, margin: 0.2, scale: 30}}
        optimizer: {{name: AdaBelief, weight_decay: 0.00002, lr_decay: 0.95}}
        callbacks: {{name: cosine_annealinglr_pt, base_lr: 0.00000001}}
        dataloader_options: {{batch_size: 3, nPerSpeaker: 2,
                              max_seg_per_spk: 500, num_workers: 2}}
        """)


def test_cli_do_train_then_eval(tmp_path, capsys):
    torch.set_num_threads(2)
    files = _corpus(tmp_path)
    trials = tmp_path / "trials.txt"
    trials.write_text("".join(
        f"{int(a == b)} {files[a][0]} {files[b][1]}\n"
        for a in files for b in files))
    cfg = tmp_path / "train.yaml"
    cfg.write_text(_yaml(tmp_path, trials))
    assert cli_main(["--do_train", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated metadata" in out and "[DONE] min_loss" in out
    assert "nClasses=99 in config but 6 speakers" in out
    run = tmp_path / "save" / "ECAPA_TDNN" / "ARmSoftmax"
    for name in ("best_state.msgpack", "last_state.msgpack",
                 "best_state_top1.msgpack", "model_state_log.json"):
        assert (run / "model" / name).exists(), name
    scores = (run / "result" / "scores.txt").read_text().splitlines()
    assert [s.split(",")[0] for s in scores] == ["epoch 1", "epoch 2"]
    assert all("VEER" in s for s in scores)
    assert (run / "result" / "settings.txt").exists()
    assert (run / "config" / "config_frozen.yaml").exists()
    assert cli_main(["--do_infer", "--eval", "--config", str(cfg),
                     "--device", "cpu"]) == 0
    assert "loaded weights" in capsys.readouterr().out
    rows = (run / "result" / "evaluation_results.csv").read_text()
    assert len(rows.strip().splitlines()) == 36 + 1


def test_sigterm_checkpoints_the_unfinished_epoch(tmp_path):
    torch.set_num_threads(2)
    _corpus(tmp_path)
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    trainer = Trainer(_hparams(tmp_path, number_of_epochs=3), device="cpu")
    step = trainer.step_fn

    def interrupted(*args):
        # the handler fit() installs, as a scheduler's SIGTERM calls it
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return step(*args)

    trainer.step_fn = interrupted
    trainer.fit()
    model = tmp_path / "save" / "ECAPA_TDNN" / "ARmSoftmax" / "model"
    meta = json.loads((model / "last_state.msgpack.json").read_text())
    assert meta["preempted"] and meta["epoch"] == 0 and meta["step"] == 1
    assert not (model / "best_state.msgpack").exists()
    assert signal.getsignal(signal.SIGTERM) is not None


@pytest.mark.parametrize("key,value", [
    ("distributed", True), ("data_parallel", True), ("model_parallel", 2),
    ("profile", True), ("sharded_checkpoints", True)])
def test_trainer_refuses_what_is_not_ported(tmp_path, key, value):
    """The JAX trainer's keys the port once refused, each taken now (the
    multi-GPU slice; ``tests/test_torch_port_parallel*.py`` run them
    across processes): ``distributed`` and its alias ``data_parallel``
    train in this one process when no process group is configured, as
    JAX trains on one device; ``model_parallel > 1`` needs
    ``distributed`` and a world of a multiple of it, with JAX's errors;
    ``sharded_checkpoints`` keeps checkpoints as sharded directories."""
    _corpus(tmp_path)
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    if key == "profile":
        # ported since the thirteenth slice: the key is taken, and names
        # the first epoch's trace (tests/test_torch_port_tools.py runs it)
        trainer = Trainer(_hparams(tmp_path, profile=value,
                                   profile_dir=str(tmp_path / "prof")),
                          device="cpu")
        assert trainer._profile_dir == tmp_path / "prof"
        return
    if key == "model_parallel":
        with pytest.raises(ValueError, match="requires --distributed"):
            Trainer(_hparams(tmp_path, model_parallel=value), device="cpu")
        with pytest.raises(ValueError, match="multiple of 2 processes"):
            Trainer(_hparams(tmp_path, model_parallel=value,
                             distributed=True), device="cpu")
        return
    trainer = Trainer(_hparams(tmp_path, **{key: value}), device="cpu")
    if key == "sharded_checkpoints":
        assert trainer.ckpt.backend == "sharded" and trainer.ckpt.SUFFIX == ""
        return
    assert trainer.hparams["distributed"] is True
    assert trainer.mesh is None and not trainer.multiprocess
    assert trainer.step_fn is not None and trainer.is_main


@pytest.mark.parametrize("flags", [["--distributed"], ["--data_parallel"],
                                   ["--model_parallel", "2"]],
                         ids=["flags0", "flags1", "flags3"])
def test_cli_refuses_what_is_not_ported(tmp_path, flags, capsys,
                                        monkeypatch):
    """The multi-device flags reach the trainer's hparams (once exit 2):
    ``--data_parallel`` as ``distributed``; without a process group and
    with at most one GPU the CLI trains in this process, spawning none."""
    import speakerverification_tpu_torch.cli.main as cli
    import speakerverification_tpu_torch.training.trainer as trainer_mod
    seen = {}

    class FakeTrainer:
        def __init__(self, hparams, device=None):
            seen.update(hparams)

        def fit(self):
            return {"min_loss": 0.0}

    monkeypatch.setattr(trainer_mod, "Trainer", FakeTrainer)
    monkeypatch.setattr(cli, "spawn_ranks", lambda *a: pytest.fail("spawned"))
    _corpus(tmp_path)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(_yaml(tmp_path, tmp_path / "t.txt"))
    assert cli_main(["--do_train", *flags, "--config", str(cfg)]) == 0
    if flags[0] == "--model_parallel":
        assert seen["model_parallel"] == 2 and not seen.get("distributed")
    else:
        assert seen["distributed"] is True and "data_parallel" not in seen
    assert "[DONE]" in capsys.readouterr().out


def test_trainer_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _corpus(tmp_path)
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_hparams(tmp_path))

