"""The CLI across processes on the CPU: ``--do_train --distributed
--distributed_backend gloo --model_parallel 2`` in two processes wired
by the ``SVTPU_*`` variables (a ``file://`` rendezvous), one epoch with
``sharded_checkpoints: true``, then ``--do_infer --eval --distributed``
in two processes from that checkpoint (the file list split over them)
against a one-process eval of the same weights. This rehearses path O6
of ``chip_smoke.py``.
"""

import csv
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.training import checkpoint_sharded as cs

ROOT = Path(__file__).resolve().parents[1]
SR = 8000
SMALL = ('{"name": "ECAPA_TDNN", "feature_type": "melspectrogram", '
         '"nOut": 16, "channels": [16, 16, 16, 16, 48], '
         '"kernel_sizes": [5, 3, 3, 3, 1], "dilations": [1, 2, 3, 4, 1], '
         '"attention_channels": 4, "res2net_scale": 2, "se_channels": 4}')


def _corpus(root, n_spk=6, n_utt=5):
    rng = np.random.default_rng(0)
    files = {}
    for spk in range(n_spk):
        for utt in range(n_utt):
            tt = np.arange(int(0.8 * SR)) / SR
            sig = 0.3 * np.sin(2 * np.pi * (120 + 60 * spk) * tt
                               + rng.uniform(0, 6)) + rng.normal(0, 0.01,
                                                                 tt.size)
            path = root / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), SR)
            files.setdefault(spk, []).append(str(path))
    return files


def _cli(args, root, world=None, timeout=300):
    """The CLI in ``world`` processes (or one), every rank's exit code."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for k in ("RANK", "WORLD_SIZE", "SVTPU_COORDINATOR",
              "SVTPU_NUM_PROCESSES", "SVTPU_PROCESS_ID"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "speakerverification_tpu_torch.cli.main",
           *args, "--device", "cpu"]
    if world is None:
        return [subprocess.run(cmd, env=env, cwd=ROOT, timeout=timeout,
                               capture_output=True, text=True)]
    store = root / f"store-{args[0]}"
    procs = [subprocess.Popen(
        cmd, env={**env, "SVTPU_COORDINATOR": f"file://{store}",
                  "SVTPU_NUM_PROCESSES": str(world),
                  "SVTPU_PROCESS_ID": str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    out = []
    try:
        for p in procs:
            p.stdout_text = p.communicate(timeout=timeout)[0]
            out.append(p)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [subprocess.CompletedProcess(p.args, p.returncode, p.stdout_text,
                                        "") for p in out]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_two_process_train_then_split_eval(tmp_path):
    files = _corpus(tmp_path)
    trials = tmp_path / "trials.txt"
    trials.write_text("".join(f"{int(a == b)} {files[a][0]} {files[b][1]}\n"
                              for a in files for b in files))
    cfg = tmp_path / "c.yaml"
    cfg.write_text(textwrap.dedent(f"""\
        seed: 3
        save_folder: {tmp_path}/save
        data_folder: {tmp_path}/data
        train_annotation: {tmp_path}/meta/train.csv
        evaluation_file: {trials}
        number_of_epochs: 1
        batch_size: 3
        lr: 0.003
        nClasses: 6
        num_eval: 2
        eval_batch_size: 3
        sharded_checkpoints: true
        audio_spec: {{sample_rate: {SR}, channels: 1, sentence_len: 0.5,
                      win_len: 0.025, hop_len: 0.01}}
        n_mels: 40
        features: melspectrogram
        model: {SMALL}
        criterion: {{name: AAmSoftmax, margin: 0.2, scale: 30}}
        optimizer: {{name: AdaBelief, weight_decay: 0.00002}}
        callbacks: {{name: cosine_annealinglr_pt, base_lr: 0.00000001}}
        dataloader_options: {{batch_size: 3, nPerSpeaker: 2,
                              max_seg_per_spk: 2, num_workers: 1}}
        """))
    # the manifests first, in one process (as the launcher's first step)
    from speakerverification_tpu_torch.data.manifest import (
        generate_metadata,
    )
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    runs = _cli(["--do_train", "--config", str(cfg), "--distributed",
                 "--distributed_backend", "gloo", "--model_parallel", "2"],
                tmp_path, world=2)
    for r in runs:
        assert r.returncode == 0, r.stdout[-3000:]
    assert "data-parallel over 1 processes x 2 model shards" in runs[0].stdout
    assert "[DONE]" in runs[0].stdout and "[E001]" not in runs[1].stdout
    mdir = tmp_path / "save" / "ECAPA_TDNN" / "AAmSoftmax" / "model"
    assert cs.is_sharded_checkpoint(mdir / "best_state")
    assert cs.is_sharded_checkpoint(mdir / "last_state")
    result = tmp_path / "save" / "ECAPA_TDNN" / "AAmSoftmax" / "result"

    runs = _cli(["--do_infer", "--eval", "--config", str(cfg),
                 "--distributed", "--distributed_backend", "gloo"],
                tmp_path, world=2)
    for r in runs:
        assert r.returncode == 0, r.stdout[-3000:]
    assert "loaded weights: " in runs[0].stdout
    split = _rows(result / "evaluation_results.csv")
    (result / "evaluation_results.csv").unlink()
    one = _cli(["--do_infer", "--eval", "--config", str(cfg)], tmp_path)[0]
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    whole = _rows(result / "evaluation_results.csv")
    assert len(split) == len(whole) == 37
    assert [(r[0], r[2]) for r in split] == [(r[0], r[2]) for r in whole]
    np.testing.assert_allclose([float(r[1]) for r in split[1:]],
                               [float(r[1]) for r in whole[1:]],
                               rtol=0, atol=1e-6)
