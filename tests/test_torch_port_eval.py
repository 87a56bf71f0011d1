"""The port's trial evaluation (``--do_infer --eval``) against the JAX
package on the CPU.

A synthetic WAV trial list (4 speakers × 4 utterances of tones over
noise, 40 trials, the ``tests/test_e2e.py`` pattern) is scored by the
port's ``InferenceEngine.evaluate`` and by the JAX package's
``evaluate_from_list`` with its metrics, on the same weights (a small
ECAPA_TDNN, JAX init carried over by ``params_from_jax``).

Tolerances: float-path scores within 1e-4 (fp32 on both sides, ~20
layers of sums in other orders), and then the same EER and minDCF and
a threshold within 1e-4 (it is one of the scores); S-norm scores within
1e-4 of their largest magnitude (the cohort std divides); int8 trial
scores within 2e-2 of the float ones, the bar of ``tests/test_e2e.py``.
"""

import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.builder import encoder_from_hparams as j_encoder
from speakerverification_tpu.evaluation import evaluator as jevaluator
from speakerverification_tpu.evaluation import metrics as jmetrics
from speakerverification_tpu.evaluation import scoring as jscoring
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu.training.train_step import make_eval_embed_fn
from speakerverification_tpu_torch.cli.main import main as cli_main
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.evaluation import evaluator as tevaluator
from speakerverification_tpu_torch.evaluation import metrics as tmetrics
from speakerverification_tpu_torch.evaluation import scoring as tscoring
from speakerverification_tpu_torch.inference import InferenceEngine
from speakerverification_tpu_torch.weights import params_from_jax

from test_torch_port_helpers import randomized_variables

SR, N_SPK, N_UTT, N_TRIALS = 8000, 4, 4, 40
ECAPA_SMALL = {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
               "nOut": 16, "channels": [16, 16, 16, 16, 48],
               "kernel_sizes": [5, 3, 3, 3, 1], "dilations": [1, 2, 3, 4, 1],
               "attention_channels": 4, "res2net_scale": 2, "se_channels": 4}


def _hparams(root, **extra):
    return {"seed": 0, "num_eval": 3, "save_folder": str(root / "save"),
            "evaluation_file": str(root / "trials.txt"),
            "cohorts_path": str(root / "cohorts.npy"),
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "model": dict(ECAPA_SMALL), "criterion": {"name": "AAmSoftmax"},
            "eval_batch_size": 6, "dataloader_options": {"num_workers": 2},
            "dcf": {"dcf_p_target": 0.05, "dcf_c_miss": 1, "dcf_c_fa": 1},
            **extra}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """WAVs, trial list, cohorts, JAX variables and the port weights."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    files = {}
    for spk in range(N_SPK):
        for utt in range(N_UTT):
            tt = np.arange(int(1.2 * SR)) / SR
            f0 = 120 + 90 * spk
            sig = sum(0.25 / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * tt
                                              + rng.uniform(0, 6))
                      for k in range(3)) + rng.normal(0, 0.01, tt.size)
            path = root / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), SR)
            files.setdefault(spk, []).append(str(path))
    rng2 = np.random.default_rng(1)
    lines = []
    for _ in range(N_TRIALS):
        s1 = int(rng2.integers(N_SPK))
        if rng2.random() < 0.5:
            a, b = rng2.choice(N_UTT, 2, replace=False)
            lines.append(f"1 {files[s1][a]} {files[s1][b]}")
        else:
            s2 = int((s1 + 1 + rng2.integers(N_SPK - 1)) % N_SPK)
            lines.append(f"0 {files[s1][0]} {files[s2][int(rng2.integers(N_UTT))]}")
    (root / "trials.txt").write_text("\n".join(lines) + "\n")
    np.save(root / "cohorts.npy",
            rng.normal(size=(6, 16)).astype(np.float32))

    h = _hparams(root)
    model = j_encoder(h, with_loss=False, num_devices=1)
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((2, int(0.5 * SR))))
    v = randomized_variables(v, seed=3)
    weights = root / "port.pt"
    torch.save(params_from_jax(v["params"], v["batch_stats"]), weights)
    embed = make_eval_embed_fn(model)

    def jax_embed(waves):
        return np.asarray(embed(v["params"], v["batch_stats"],
                                jnp.asarray(waves)))

    return root, h, weights, jax_embed


def _csv_scores(h):
    path = (Path(h["save_folder"]) / "ECAPA_TDNN" / h["criterion"]["name"]
            / "result" / "evaluation_results.csv")
    rows = path.read_text().strip().splitlines()
    assert rows[0] == "label,score,trial"
    return np.array([float(r.split(",")[1]) for r in rows[1:]])


def _jax_eval(h, jax_embed, mode="cosine", cohorts=None):
    scores, labels, _ = jevaluator.evaluate_from_list(
        jax_embed, h["evaluation_file"], h["audio_spec"],
        num_eval=h["num_eval"], scoring_mode=mode, cohorts=cohorts,
        normalize=False, batch_size=h["eval_batch_size"], num_workers=2)
    res = jmetrics.tune_threshold_from_score(scores, labels, [1, 0.1])
    fnrs, fprs, thr = jmetrics.compute_error_rates(scores, labels)
    mindcf, _ = jmetrics.compute_min_dcf(fnrs, fprs, thr)
    return scores, res["roc"][1], mindcf, res["roc"][3]


def test_eval_float_matches_jax(ws):
    root, h, weights, jax_embed = ws
    report = InferenceEngine(h, weights=str(weights),
                             device="cpu").evaluate()
    scores = _csv_scores(h)
    ref, eer, mindcf, thr = _jax_eval(h, jax_embed)
    assert report["n_trials"] == N_TRIALS == len(scores)
    np.testing.assert_allclose(scores, ref, atol=1e-4)
    assert report["eer"] == eer and report["min_dcf"] == mindcf
    assert report["threshold"] == pytest.approx(thr, abs=1e-4)
    result = root / "save" / "ECAPA_TDNN" / "AAmSoftmax" / "result"
    assert "EER" in (result / "Inference_log.txt").read_text()
    assert (result / "false_accept_pairs.txt").exists()


def test_eval_snorm_matches_jax(ws):
    root, h, weights, jax_embed = ws
    h = {**h, "scoring_mode": "norm"}
    InferenceEngine(h, weights=str(weights), device="cpu").evaluate()
    ref, *_ = _jax_eval(h, jax_embed, "norm",
                        np.load(root / "cohorts.npy"))
    np.testing.assert_allclose(_csv_scores(h), ref,
                               atol=1e-4 * np.abs(ref).max())


def test_eval_int8_tracks_float(ws):
    """ECAPA at 512 channels, so that the default floors quantize its
    11 large GEMMs: int8 trial scores within 2e-2 of the float ones."""
    torch.set_num_threads(2)
    root, h, _, _ = ws
    h = {**h, "model": {"name": "ECAPA_TDNN",
                        "feature_type": "melspectrogram", "nOut": 192,
                        "channels": [512, 512, 512, 512, 1536]},
         "save_folder": str(root / "save512")}
    InferenceEngine(h, device="cpu").evaluate()
    float_scores = _csv_scores(h)
    engine = InferenceEngine({**h, "quant": "int8"}, device="cpu")
    engine.evaluate()
    assert len(engine.act_scales) == 11
    diff = np.abs(_csv_scores(h) - float_scores)
    assert diff.max() < 2e-2 and diff.max() > 0


def test_cli_eval_writes_one_row_per_trial(ws, tmp_path, capsys):
    torch.set_num_threads(2)
    root, h, weights, _ = ws
    cfg = tmp_path / "config.yaml"
    cfg.write_text(textwrap.dedent(f"""\
        seed: 0
        save_folder: {tmp_path}/save
        evaluation_file: {root}/trials.txt
        verification_file: {root}/trials.txt
        test_threshold: 0
        prepare: embed
        data_folder: {root}/data
        num_eval: 3
        eval_batch_size: 6
        audio_spec: {{sample_rate: {SR}, channels: 1, sentence_len: 0.5,
                      win_len: 0.025, hop_len: 0.01}}
        n_mels: 40
        features: melspectrogram
        model: {dict(ECAPA_SMALL)}
        criterion: {{name: AAmSoftmax}}
        """))
    args = ["--config", str(cfg), "--device", "cpu"]
    assert cli_main(["--do_infer", "--eval", *args,
                     "--initial_model_infer", str(weights)]) == 0
    csv = tmp_path / "save" / "ECAPA_TDNN" / "AAmSoftmax" / "result" / \
        "evaluation_results.csv"
    assert len(csv.read_text().strip().splitlines()) == N_TRIALS + 1
    assert "[RESULT] EER" in capsys.readouterr().out
    run = tmp_path / "save" / "ECAPA_TDNN" / "AAmSoftmax"
    assert (run / "config" / "config_frozen.yaml").exists()
    # the other inference verbs, ported: --test (threshold 0: tuned on the
    # eval list first), --prepare (the YAML's prepare: embed) and --predict
    w = ["--initial_model_infer", str(weights)]
    assert cli_main(["--do_infer", "--test", *args, *w]) == 0
    assert "precision" in capsys.readouterr().out
    results = run / "result" / "trials_results.txt"
    assert len(results.read_text().strip().splitlines()) == N_TRIALS
    assert cli_main(["--do_infer", "--prepare", *args, *w]) == 0
    assert np.load(run / "model" / "embeds.npy").shape == (N_SPK, 16)
    wavs = sorted(str(p) for p in (root / "data").glob("spk*/u0.wav"))
    assert cli_main(["--do_infer", "--predict", *wavs, *args, *w]) == 0
    assert capsys.readouterr().out.count("[RESULT] predict: spk") == N_SPK
    # --do_train runs now; a process group backend the port does not
    # have exits 2 by name; --do_export writes the program, weights and
    # config
    assert cli_main(["--do_train", "--distributed", "--distributed_backend",
                     "mpi", *args]) == 2
    assert "'mpi' is not supported" in capsys.readouterr().err
    assert cli_main(["--do_export", *args, *w]) == 0
    assert "[INFO] exported to" in capsys.readouterr().out
    assert {p.name for p in (run / "model" / "export").iterdir()} == {
        "params.msgpack", "config.json", "model.pt2"}
    # --do_infer alone has no verb to run, --predict no files: no silent
    # success
    assert cli_main(["--do_infer", *args]) == 2
    assert "needs --eval" in capsys.readouterr().err
    assert cli_main(["--do_infer", "--eval", "--predict", *args]) == 2
    assert "at least one audio file" in capsys.readouterr().err


def test_prototypical_head_scores_unnormalized_like_jax(tmp_path):
    """``criterion: Prototypical`` has ``test_normalize = False``: both
    engines return unnormalized embeddings."""
    h = {**_hparams(tmp_path), "criterion": {"name": "Prototypical"}}
    jeng = JEngine(h)
    weights = tmp_path / "port.pt"
    params, stats = jax.tree.map(np.array, (jeng.state.params,
                                            jeng.state.batch_stats))
    torch.save(params_from_jax(params, stats), weights)
    waves = (0.2 * np.random.default_rng(4).normal(
        0, 1, (3, int(0.5 * SR)))).astype(np.float32)
    ref = np.asarray(jeng.embed_fn(waves))
    got = InferenceEngine(h, weights=str(weights),
                          device="cpu").embed_fn(waves).numpy()
    assert np.abs(np.linalg.norm(ref, axis=1) - 1).min() > 1e-2
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
    normed = InferenceEngine({**h, "criterion": {"name": "AAmSoftmax"}},
                             weights=str(weights), device="cpu")
    np.testing.assert_allclose(
        np.linalg.norm(normed.embed_fn(waves).numpy(), axis=1), 1, atol=1e-5)


@pytest.mark.parametrize("mode", ["cosine", "pnorm", "distance", "norm"])
@pytest.mark.parametrize("normalize", [True, False])
def test_score_trials_matches_jax(mode, normalize):
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(7, 3, 12)).astype(np.float32)
    # trials pair two different files: a file against itself puts the
    # distance mode's sqrt on rounding noise around 0
    ridx = rng.integers(0, 7, 20)
    cidx = (ridx + rng.integers(1, 7, 20)) % 7
    cohorts = rng.normal(size=(9, 12)).astype(np.float32)
    kw = dict(mode=mode, cohorts=cohorts, top=5, normalize=normalize)
    ref = jscoring.score_trials(emb, ridx, cidx, **kw)
    got = tscoring.score_trials(torch.from_numpy(emb), ridx, cidx, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 2, 200)
    scores = labels * 0.5 + rng.normal(size=200)
    ref = jmetrics.tune_threshold_from_score(scores, labels, [1, 0.1])
    got = tmetrics.tune_threshold_from_score(scores, labels, [1, 0.1])
    assert got["roc"] == ref["roc"] and got["gmean"] == ref["gmean"]
    assert (tmetrics.compute_min_dcf(*tmetrics.compute_error_rates(
        scores, labels)) == jmetrics.compute_min_dcf(
        *jmetrics.compute_error_rates(scores, labels)))


def test_trial_parsing_matches_jax(tmp_path):
    good = tmp_path / "good.csv"
    good.write_text("label,enroll,test\n1,a.wav,b.wav\n0, c.wav ,d.wav\n")
    for mod in (jevaluator, tevaluator):
        assert mod.sniff_has_label(good)
    labels, refs, coms = tevaluator.parse_trials(good)
    j = jevaluator.parse_trials(good)
    assert labels.tolist() == j[0].tolist() and (refs, coms) == j[1:]
    unlabeled = tmp_path / "pairs.txt"
    unlabeled.write_text("a.wav b.wav\nc.wav d.wav\n")
    assert not tevaluator.sniff_has_label(unlabeled)
    assert tevaluator.parse_trials(unlabeled, with_label=False)[1:] == \
        jevaluator.parse_trials(unlabeled, with_label=False)[1:]
    bad = tmp_path / "bad.txt"
    bad.write_text("1 a.wav b.wav\nx a.wav b.wav\n")
    for mod in (jevaluator, tevaluator):
        with pytest.raises(ValueError, match="bad trial line 1"):
            mod.parse_trials(bad)
