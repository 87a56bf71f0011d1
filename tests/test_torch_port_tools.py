"""The port's tools against the JAX package's, on the CPU.

``--list_components`` (the JAX lines, but for the names the port refuses
by name), ``--sys_info``, ``utils.summary`` (parameter tables on bridged
weights, the frame count, ``forward_flops``), ``utils.plotting`` (the
same file names), ``reports.evaluate_result`` (the same dict, in both
decision formats), ``evaluation.benchmark`` (``benchmark_models`` and
``benchmark_dataset`` on bridged weights: the same EERs, minDCFs and
accuracies, thresholds within 1e-4) and the trainer's ``profile`` key.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.builder import encoder_from_hparams as j_encoder
from speakerverification_tpu.evaluation import benchmark as jbench
from speakerverification_tpu.evaluation import reports as jreports
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu.utils import plotting as jplot
from speakerverification_tpu.utils import summary as jsummary
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.checkpoint import save_checkpoint
from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.data.manifest import generate_metadata
from speakerverification_tpu_torch.evaluation import benchmark as tbench
from speakerverification_tpu_torch.evaluation import reports as treports
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.training.trainer import Trainer
from speakerverification_tpu_torch.utils import plotting as tplot
from speakerverification_tpu_torch.utils import summary as tsummary
from speakerverification_tpu_torch.utils import sysinfo as tsysinfo

from test_torch_port_helpers import randomized_variables

ROOT = Path(__file__).resolve().parents[1]
SR = 8000
# the JAX names the port refuses by name (none since the multi-GPU slice
# registered ShardedAAmSoftmax)
REFUSED = set()
ECAPA_SMALL = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
               "nOut": 16, "channels": [16, 16, 16, 16, 48],
               "kernel_sizes": [5, 3, 3, 3, 1], "dilations": [1, 2, 3, 4, 1],
               "attention_channels": 4, "res2net_scale": 2, "se_channels": 4}


def test_list_components_equals_jax_but_the_refused_names(capsys):
    assert cli_main(["--list_components"]) == 0
    ours = capsys.readouterr().out.strip().splitlines()
    out = subprocess.run(
        [sys.executable, "-m", "speakerverification_tpu.cli.main",
         "--list_components"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                          "PYTHONPATH": str(ROOT)}, check=True)
    theirs = out.stdout.strip().splitlines()
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        title_a, _, names_a = a.partition(": ")
        title_b, _, names_b = b.partition(": ")
        kept = [n for n in names_b.split(", ") if n not in REFUSED]
        assert names_a.split(", ") == kept
        assert title_a == title_b.replace(
            f"({len(names_b.split(', '))})", f"({len(kept)})")


def test_sys_info_without_a_config(capsys):
    assert cli_main(["--sys_info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("System information:")
    assert f"torch_version: {torch.__version__}" in out
    info = tsysinfo.get_sys_information()
    assert info["cpu_count"] >= 1 and info["devices"][0] == "cpu"
    assert "cuda_version" in info and "jax_version" not in info


@pytest.mark.parametrize("yaml", ["model_plot.yaml", "raw3_ecapa.yaml"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_parameter_tables_equal_jax(yaml, depth):
    """The yaml's full-width model: the port's table (through the weight
    bridge) against JAX's on the shapes of its init (nothing compiled)."""
    h = read_config(ROOT / "yaml" / yaml)
    model = TB.encoder_from_hparams(h, with_loss=False)
    T = int(h["audio_spec"]["sentence_len"] * h["audio_spec"]["sample_rate"])
    jm = j_encoder(h, with_loss=False, num_devices=1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, T)))
    assert tsummary.count_params(model) == jsummary.count_params(
        shapes["params"])
    assert tsummary.summarize_params(model, depth) == \
        jsummary.summarize_params(shapes["params"], depth)


@pytest.mark.parametrize("center", [True, False])
def test_mel_frames_for_spec(center):
    for spec in ({"sample_rate": 8000, "sentence_len": 2.0},
                 {"sample_rate": 16000, "sentence_len": 3.3,
                  "hop_len": 0.02, "win_len": 0.05}):
        assert tsummary.mel_frames_for_spec(spec, center) == \
            jsummary.mel_frames_for_spec(spec, center)


def test_forward_flops_of_a_linear_layer():
    lin = torch.nn.Linear(24, 10)
    assert tsummary.forward_flops(lin, torch.zeros(7, 24)) == 2 * 7 * 24 * 10
    assert lin.training


def test_forward_flops_through_the_kernels_equal_the_plain_path():
    h = {"audio_spec": {"sample_rate": SR, "sentence_len": 0.5},
         "n_mels": 40, "features": "melspectrogram",
         "model": {**ECAPA_SMALL, "channels": [64, 64, 64, 64, 192],
                   "res2net_scale": 8}}
    counts = []
    for backend in ("pallas", "xla"):
        model = TB.encoder_from_hparams(
            {**h, "frontend_backend": backend,
             "model": {**h["model"], "conv_backend": backend}})
        counts.append(tsummary.forward_flops(model, torch.zeros(2, 4000)))
    assert counts[0] == counts[1] > 0


def test_forward_flops_leaves_the_engines_module_in_eval_mode(tmp_path):
    h = {"audio_spec": {"sample_rate": SR, "sentence_len": 0.5},
         "n_mels": 40, "features": "melspectrogram", "model": ECAPA_SMALL,
         "save_folder": str(tmp_path / "save")}
    module = InferenceEngine(h, device="cpu")._embed.module
    assert tsummary.forward_flops(module, torch.zeros(2, 4000)) > 0
    assert not any(m.training for m in module.modules())


def test_summary_cli_runs(tmp_path):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(json.dumps({
        "audio_spec": {"sample_rate": SR, "sentence_len": 0.5},
        "n_mels": 40, "features": "melspectrogram",
        "model": ECAPA_SMALL}))
    out = subprocess.run(
        [sys.executable, "-m", "speakerverification_tpu_torch.utils.summary",
         "--config", str(cfg)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True).stdout
    assert "total" in out and "-> 51 mel frames" in out
    assert "GFLOPs/utt" in out


# ----------------------------------------------------------------------
# plots and reports
# ----------------------------------------------------------------------
def test_plots_write_the_jax_file_names(tmp_path):
    scores = ("epoch 1, LR 0.00300000, TEER/TAcc 10.00, TLOSS 8.500000\n"
              "epoch 2, LR 0.00250000, TEER/TAcc 50.00, TLOSS 4.2, "
              "VEER 12.5000\n")
    names = []
    for pkg, root in ((tplot, tmp_path / "port"), (jplot, tmp_path / "jax")):
        root.mkdir()
        (root / "scores.txt").write_text(scores)
        out = pkg.plot_from_scores(root)
        out.append(pkg.plot_confusion_matrix([0, 1, 1, 0], [0, 1, 0, 0],
                                             root / "cm.png"))
        rng = np.random.default_rng(5)
        out.append(pkg.plot_embeddings_3d(rng.normal(size=(20, 16)),
                                          [i % 4 for i in range(20)],
                                          root / "emb.png"))
        assert all(Path(p).exists() for p in out)
        names.append(sorted(p.name for p in root.iterdir()))
    assert names[0] == names[1]
    assert tplot.parse_scores_file(tmp_path / "port" / "scores.txt") == \
        jplot.parse_scores_file(tmp_path / "jax" / "scores.txt")


def _decision_files(root):
    rng = np.random.default_rng(8)
    truth, ours, csv = [], [], ["file1,file2,pred"]
    for i in range(60):
        a, b = f"spk{i % 5}/u{i}.wav", f"spk{(i * 3) % 5}/v{i}.wav"
        label = int(rng.random() < 0.5)
        pred = label if rng.random() < 0.8 else 1 - label
        truth.append(f"{label} {a} {b}")
        if i % 7:                          # some trials left unmatched
            ours.append(f"{pred} {rng.normal():.6f} {a} {b}")
            csv.append(f"{a},{b},{pred}")
    (root / "truth.txt").write_text("\n".join(truth) + "\n")
    (root / "ours.txt").write_text("\n".join(ours) + "\n")
    (root / "ref.csv").write_text("\n".join(csv) + "\n")


@pytest.mark.parametrize("decisions", ["ours.txt", "ref.csv"])
def test_evaluate_result_equals_jax(tmp_path, decisions):
    _decision_files(tmp_path)
    com, ref = tmp_path / decisions, tmp_path / "truth.txt"
    got = treports.evaluate_result(com, ref, save_cm=tmp_path / "cm.png")
    want = jreports.evaluate_result(com, ref, beta_values=(0.5, 2))
    assert got == want
    assert got["n_unmatched"] > 0 and (tmp_path / "cm.png").exists()
    other = tmp_path / "other.txt"
    other.write_text("1 a.wav b.wav\n")
    with pytest.raises(ValueError, match="no matching"):
        treports.evaluate_result(com, other)


# ----------------------------------------------------------------------
# the benchmark harness, on bridged weights
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(0)
    files, labels = [], []
    for spk in range(3):
        for utt in range(3):
            tt = np.arange(int(1.2 * SR)) / SR
            sig = sum(0.25 / (k + 1) * np.sin(2 * np.pi * (120 + 90 * spk)
                                              * (k + 1) * tt
                                              + rng.uniform(0, 6))
                      for k in range(3)) + rng.normal(0, 0.01, tt.size)
            path = root / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), SR)
            files.append(str(path))
            labels.append(spk)
    trials = [f"{int(labels[i] == labels[j])} {files[i]} {files[j]}"
              for i in range(9) for j in range(i + 1, 9)]
    (root / "trials.txt").write_text("\n".join(trials) + "\n")
    h = {"seed": 0, "num_eval": 3, "save_folder": str(root / "save"),
         "audio_spec": {"sample_rate": SR, "channels": 1,
                        "sentence_len": 0.5, "win_len": 0.025,
                        "hop_len": 0.01},
         "n_mels": 40, "features": "melspectrogram",
         "model": dict(ECAPA_SMALL), "criterion": {"name": "AAmSoftmax"}}
    model = j_encoder(h, with_loss=False, num_devices=1)
    ckpts = root / "ckpts"
    for seed in (3, 4):
        v = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((2, int(0.5 * SR))))
        v = randomized_variables(v, seed=seed)
        save_checkpoint(ckpts / f"model_state_{seed}.msgpack",
                        {"params": v["params"],
                         "batch_stats": v["batch_stats"]}, {"epoch": seed})
    return root, h, files, labels, ckpts


def test_benchmark_models_equals_jax(bench):
    root, h, _, _, ckpts = bench
    trials = root / "trials.txt"
    got = tbench.benchmark_models(
        lambda p: InferenceEngine(h, weights=str(p), device="cpu").embed_fn,
        ckpts, trials, h["audio_spec"], num_eval=3,
        save_json=root / "bench.json")
    want = jbench.benchmark_models(
        lambda p: JEngine(h, weights=str(p)).embed_fn,
        ckpts, trials, h["audio_spec"], num_eval=3)
    assert [r["checkpoint"] for r in got] == [r["checkpoint"] for r in want]
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a["eer"] == pytest.approx(b["eer"], abs=1e-6)
        assert a["min_dcf"] == pytest.approx(b["min_dcf"], abs=1e-6)
        assert a["threshold"] == pytest.approx(b["threshold"], abs=1e-4)
    assert json.loads((root / "bench.json").read_text())[0]["checkpoint"] \
        == got[0]["checkpoint"]


def test_benchmark_dataset_equals_jax(bench):
    _, h, files, labels, ckpts = bench
    ckpt = str(sorted(ckpts.iterdir())[0])
    got = tbench.benchmark_dataset(
        InferenceEngine(h, weights=ckpt, device="cpu").embed_fn, files,
        labels, h["audio_spec"], num_eval=3)
    want = jbench.benchmark_dataset(JEngine(h, weights=ckpt).embed_fn, files,
                                    labels, h["audio_spec"], num_eval=3)
    assert got == want
    assert got["n_files"] == 9 and set(got["per_speaker"]) == {"0", "1", "2"}


# ----------------------------------------------------------------------
# the trainer's profile
# ----------------------------------------------------------------------
def test_trainer_profile_writes_a_chrome_trace(tmp_path, capsys):
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    for spk in range(6):
        for utt in range(5):
            write_wav(tmp_path / "data" / f"spk{spk}" / f"u{utt}.wav",
                      rng.normal(0, 0.1, int(1.2 * SR)).astype(np.float32),
                      SR)
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    h = {"seed": 3, "save_folder": str(tmp_path / "save"),
         "train_annotation": str(tmp_path / "meta" / "train.csv"),
         "valid_annotation": str(tmp_path / "meta" / "dev.csv"),
         "audio_spec": {"sample_rate": SR, "channels": 1,
                        "sentence_len": 0.5},
         "n_mels": 40, "features": "melspectrogram",
         "model": dict(ECAPA_SMALL), "nClasses": 6, "lr": 0.003,
         "number_of_epochs": 1, "batch_size": 3, "num_eval": 2,
         "criterion": {"name": "AAmSoftmax"},
         "dataloader_options": {"batch_size": 3, "nPerSpeaker": 2,
                                "num_workers": 1},
         "profile": True, "profile_dir": str(tmp_path / "prof")}
    Trainer(h, device="cpu").fit()
    out = capsys.readouterr().out
    assert f"profiler trace written to {tmp_path / 'prof'}" in out
    # the step's spans read back: host time, no stream time on the CPU
    assert "profiled steps: " in out and "of stream" not in out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]
             if e.get("cat") == "cpu_op"}
    assert "aten::convolution" in names or "aten::conv1d" in names
    assert any(n.startswith("aten::") for n in names)
