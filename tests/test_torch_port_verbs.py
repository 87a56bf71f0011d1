"""The port's inference verbs against the JAX package, on the CPU.

``prepare_cohorts``, ``prepare_embeddings``, ``test_from_list`` and the
decision-run reports are held against the JAX functions with the same
embed function (a seeded projection of the crops, numpy on both sides):
the same arrays to 1e-6 (fp32 means and norms in another order) and the
report text character for character. Then a small ECAPA goes through
both CLIs with ``--device cpu`` from the same JAX-written checkpoint:
``--prepare`` (embed, then cohorts), ``--eval`` (cosine, then S-norm on
the prepared cohorts), ``--test`` and ``--predict`` write the same
artifacts, scores within the fp32 tolerance of
``test_torch_port_eval.py`` (1e-4).
"""

import textwrap

import jax
import numpy as np
import pytest
import torch
import yaml

from speakerverification_tpu.cli.main import main as jax_cli
from speakerverification_tpu.evaluation import evaluator as jevaluator
from speakerverification_tpu.evaluation import reports as jreports
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu.training.checkpoint import save_checkpoint
from speakerverification_tpu_torch.cli.main import main as port_cli
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.evaluation import evaluator as tevaluator
from speakerverification_tpu_torch.evaluation import reports as treports

SR = 8000
SPEC = {"sample_rate": SR, "channels": 1, "sentence_len": 0.25,
        "win_len": 0.025, "hop_len": 0.01}
N_SPK, N_UTT = 4, 2

LABELS = {
    "balanced": ([0, 0, 1, 1, 1, 0, 1, 0], [0, 1, 1, 1, 0, 0, 1, 1]),
    "all positive truth": ([1, 1, 1, 1], [1, 0, 1, 1]),
    "no positive prediction": ([0, 1, 0, 1, 0], [0, 0, 0, 0, 0]),
    "perfect": ([1, 0, 1], [1, 0, 1]),
    "three classes": ([0, 2, 1, 2, 0], [0, 2, 2, 1, 0]),
}


@pytest.mark.parametrize("case", sorted(LABELS))
def test_reports_match_jax_text_exactly(case):
    y_true, y_pred = (np.asarray(v) for v in LABELS[case])
    for beta in (0.5, 1.0, 2.0):
        assert treports.fbeta_score(y_true, y_pred, beta) == \
            jreports.fbeta_score(y_true, y_pred, beta)
    names = ["Label '0'", "Label '1'"]
    for target in (names, None):
        for digits in (5, 3):
            assert treports.classification_report(
                y_true, y_pred, target, digits) == \
                jreports.classification_report(y_true, y_pred, target, digits)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Speaker folders of 1.2 s WAVs, a train list (CSV and plain), a
    labeled and an unlabeled trial list, and a seeded embed function."""
    root = tmp_path_factory.mktemp("verbs")
    rng = np.random.default_rng(0)
    files = {}
    tt = np.arange(int(1.2 * SR)) / SR
    for spk in range(N_SPK):
        for utt in range(N_UTT):
            sig = 0.3 * np.sin(2 * np.pi * (120 + 80 * spk) * tt
                               + rng.uniform(0, 6)) \
                + 0.02 * rng.normal(size=tt.size)
            path = root / "data" / f"spk{spk}" / f"u{utt}.wav"
            write_wav(path, sig.astype(np.float32), SR)
            files.setdefault(spk, []).append(str(path))
    flat = [(f"spk{s}", p) for s, ps in files.items() for p in ps]
    (root / "train.csv").write_text(
        "speaker,path,extra\n" + "".join(f"{s},{p},x\n" for s, p in flat))
    (root / "train.txt").write_text("".join(f"{s} {p}\n" for s, p in flat))
    lines = []
    for i in range(12):
        a, b = i % N_SPK, (i + i // N_SPK) % N_SPK
        lines.append((int(a == b), files[a][0], files[b][1]))
    (root / "trials.txt").write_text(
        "".join(f"{l} {p} {q}\n" for l, p, q in lines))
    (root / "unlabeled.txt").write_text(
        "".join(f"{p},{q}\n" for _, p, q in lines))
    proj = rng.normal(size=(2000, 12)).astype(np.float32)

    def embed(waves):
        return np.tanh(np.asarray(waves, np.float32) @ proj)

    return root, files, embed


@pytest.mark.parametrize("name", ["train.csv", "train.txt"])
def test_read_manifest_pairs_matches_jax(data, name):
    root = data[0]
    got = tevaluator._read_manifest_pairs(root / name)
    assert got == jevaluator._read_manifest_pairs(root / name)
    assert len(got) == N_SPK * N_UTT


def test_prepare_cohorts_matches_jax(data, tmp_path):
    root, _, embed = data
    kw = dict(num_eval=2, n_emb_per_spk=1, num_workers=1)
    got = tevaluator.prepare_cohorts(embed, root / "train.csv", SPEC,
                                     save_path=str(tmp_path / "t.npy"), **kw)
    ref = jevaluator.prepare_cohorts(embed, root / "train.csv", SPEC,
                                     save_path=str(tmp_path / "j.npy"), **kw)
    assert got.shape == (N_SPK, 12)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), got)


@pytest.mark.parametrize("normalize", [True, False])
def test_prepare_embeddings_matches_jax(data, tmp_path, normalize):
    root, _, embed = data
    kw = dict(num_eval=2, normalize=normalize, num_workers=1)
    got = tevaluator.prepare_embeddings(embed, root / "data", SPEC,
                                        save_dir=str(tmp_path / "t"), **kw)
    ref = jevaluator.prepare_embeddings(embed, root / "data", SPEC,
                                        save_dir=str(tmp_path / "j"), **kw)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=1e-6)
    assert got[1] == ref[1] == {i: f"spk{i}" for i in range(N_SPK)}
    assert np.load(tmp_path / "t" / "classes.npy",
                   allow_pickle=True).item() == got[1]


@pytest.mark.parametrize("mode", ["cosine", "norm"])
@pytest.mark.parametrize("listname", ["trials.txt", "unlabeled.txt"])
def test_test_from_list_matches_jax(data, tmp_path, mode, listname):
    root, _, embed = data
    cohorts = np.random.default_rng(2).normal(size=(6, 12)).astype(np.float32)
    kw = dict(num_eval=2, scoring_mode=mode, cohorts=cohorts, top=4,
              normalize=True, num_workers=1)
    got = tevaluator.test_from_list(embed, root / listname, SPEC, 0.1,
                                    output_file=str(tmp_path / "t.txt"), **kw)
    ref = jevaluator.test_from_list(embed, root / listname, SPEC, 0.1,
                                    output_file=str(tmp_path / "j.txt"), **kw)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    if ref[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2], ref[2])
    t_lines = (tmp_path / "t.txt").read_text().splitlines()
    j_lines = (tmp_path / "j.txt").read_text().splitlines()
    assert [ln.split()[::2] for ln in t_lines] == \
        [ln.split()[::2] for ln in j_lines]          # decisions and files


def _config(path, root, save, prepare, mode):
    path.write_text(textwrap.dedent(f"""\
        seed: 0
        save_folder: {save}
        data_folder: {root}/data
        train_annotation: {root}/train.csv
        cohorts_path: {save}/cohorts.npy
        evaluation_file: {root}/trials.txt
        verification_file: {root}/trials.txt
        test_threshold: 0
        prepare: {prepare}
        scoring_mode: {mode}
        num_eval: 2
        eval_batch_size: 3
        dataloader_options: {{num_workers: 1}}
        audio_spec: {{sample_rate: {SR}, channels: 1, sentence_len: 0.5,
                      win_len: 0.025, hop_len: 0.01}}
        n_mels: 40
        nClasses: 10
        features: melspectrogram
        model: {{name: ECAPA_TDNN, feature_type: melspectrogram, nOut: 16,
                 channels: [16, 16, 16, 16, 48], kernel_sizes: [5, 3, 3, 3, 1],
                 dilations: [1, 2, 3, 4, 1], attention_channels: 4,
                 res2net_scale: 2, se_channels: 4}}
        criterion: {{name: AAmSoftmax}}
        """))
    return str(path)


def _scores(path):
    rows = path.read_text().strip().splitlines()[1:]
    return np.array([float(r.split(",")[1]) for r in rows])


def test_cli_verbs_write_the_jax_clis_artifacts(data, tmp_path, capsys):
    """Both CLIs, ``--device cpu``, from one JAX-written best_state in
    each run's model directory: prepare embed + eval + test + predict in
    one call, then prepare cohorts + eval with S-norm."""
    torch.set_num_threads(2)
    root, files, _ = data
    run = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        save = tmp_path / side
        cfg = _config(tmp_path / f"{side}.yaml", root, save, "embed",
                      "cosine")
        mdir = save / "ECAPA_TDNN" / "AAmSoftmax" / "model"
        if side == "jax":
            h = yaml.safe_load(open(cfg))
            jeng = JEngine(h)
            rng = np.random.default_rng(6)
            state = jeng.state.replace(params=jax.tree.map(
                lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape)
                .astype(np.float32), jeng.state.params))
            ckpt = save_checkpoint(mdir / "best_state.msgpack", state)
        else:
            mdir.mkdir(parents=True, exist_ok=True)
            (mdir / "best_state.msgpack").write_bytes(ckpt.read_bytes())
        predict = [files[s][0] for s in range(N_SPK)]
        assert cli(["--do_infer", "--prepare", "--eval", "--test",
                    "--predict", *predict, "--config", cfg,
                    "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        result = mdir.parent / "result"
        run[side] = {
            "embeds": np.load(mdir / "embeds.npy"),
            "classes": np.load(mdir / "classes.npy",
                               allow_pickle=True).item(),
            "eval": _scores(result / "evaluation_results.csv"),
            "test": (result / "trials_results.txt").read_text(),
            "report": (result / "Testing_log.txt").read_text()
            .split("\n", 1)[1],
            "frozen": yaml.safe_load(open(mdir.parent / "config" /
                                          "config_frozen.yaml")),
            "out": out}
        cfg = _config(tmp_path / f"{side}_norm.yaml", root, save, "cohorts",
                      "norm")
        assert cli(["--do_infer", "--prepare", "--eval", "--config", cfg,
                    "--device", "cpu"]) == 0
        run[side]["cohorts"] = np.load(save / "cohorts.npy")
        run[side]["norm"] = _scores(result / "evaluation_results.csv")
    got, ref = run["port"], run["jax"]
    np.testing.assert_allclose(got["embeds"], ref["embeds"], atol=1e-4)
    assert got["classes"] == ref["classes"]
    np.testing.assert_allclose(got["eval"], ref["eval"], atol=1e-4)
    assert [ln.split()[::2] for ln in got["test"].splitlines()] == \
        [ln.split()[::2] for ln in ref["test"].splitlines()]
    assert got["report"] == ref["report"]
    np.testing.assert_allclose(got["cohorts"], ref["cohorts"], atol=1e-4)
    np.testing.assert_allclose(got["norm"], ref["norm"],
                               atol=1e-4 * np.abs(ref["norm"]).max())
    for frozen in (got["frozen"], ref["frozen"]):
        frozen.pop("save_folder")
        frozen.pop("cohorts_path")
    assert got["frozen"] == ref["frozen"]
    named = [ln.split()[2] for ln in got["out"].splitlines()
             if ln.startswith("[RESULT] predict:")]
    assert len(named) == N_SPK and set(named) <= set(got["classes"].values())
