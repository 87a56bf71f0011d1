"""``python -m speakerverification_tpu_torch.cli.dataprep`` against the JAX
package's ``cli.dataprep``, flag by flag, and ``data/vad.py``,
``data/quality.py``, ``data/wav_conversion.py`` and ``data/dataprep.py``
function by function.

Each CLI test builds the same workspace twice (``jax/`` and ``port/``:
speakers' WAVs, one quiet and one short file for the filter, a MUSAN-
layout noise folder, a config), runs one package's CLI in each, and
compares what they print (with the workspace's root replaced) and the
files they leave, byte for byte. No command reaches the network: the
download test's file is present with its checksum, and the ``wget``
subprocess of both packages is replaced by one that fails the test.
"""

from __future__ import annotations

import io
import json
import tarfile
import zipfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from speakerverification_tpu.cli.dataprep import main as jmain
from speakerverification_tpu.data import dataprep as jdp
from speakerverification_tpu.data import quality as jq
from speakerverification_tpu.data import vad as jvad
from speakerverification_tpu.data import wav_conversion as jwc
from speakerverification_tpu_torch.cli.dataprep import main as tmain
from speakerverification_tpu_torch.data import dataprep as tdp
from speakerverification_tpu_torch.data import quality as tq
from speakerverification_tpu_torch.data import vad as tvad
from speakerverification_tpu_torch.data import wav_conversion as twc
from speakerverification_tpu_torch.data.wavio import read_wav, write_wav

from test_torch_port_augment_helpers import write_noise_corpus

SR = 8000


def _speech(rng, seconds: float, f0: float) -> np.ndarray:
    """A tone in bursts (voiced and unvoiced stretches) over light noise."""
    t = np.arange(int(seconds * SR)) / SR
    env = (np.sin(2 * np.pi * 1.1 * t) > 0).astype(np.float32)
    return (0.4 * env * np.sin(2 * np.pi * f0 * t)
            + rng.normal(0, 0.003, t.size)).astype(np.float32)


def workspace(root: Path) -> Path:
    """The corpus and config under ``root``; returns the config path."""
    rng = np.random.default_rng(0)
    data = root / "data"
    for spk in range(3):
        for u in range(5):
            write_wav(data / f"spk{spk}" / f"u{u}.wav",
                      _speech(rng, 1.5, 200 + 80 * spk), SR)
    write_wav(data / "spk0" / "quiet.wav",
              rng.normal(0, 1e-4, SR).astype(np.float32), SR)
    write_wav(data / "spk1" / "short.wav", _speech(rng, 0.2, 300), SR)
    write_wav(data / "spk2" / "interview_augmented.wav",
              _speech(rng, 1.0, 260), SR)
    musan = root / "noise" / "musan"
    for cat, n in (("noise", 9), ("music", 7)):
        write_wav(musan / cat / "set" / f"{cat}0.wav",
                  rng.normal(0, 0.1, n * SR).astype(np.float32), SR)
    opts = write_noise_corpus(root / "aug")
    cfg = {"data_folder": str(data),
           "train_annotation": str(root / "meta" / "train.csv"),
           "noise_folder": str(root / "noise"), "seed": 0,
           "audio_spec": {"sample_rate": SR, "sentence_len": 0.5,
                          "win_len": 0.025, "hop_len": 0.01},
           "dataloader_options": {"split_ratio": -1},
           "augment_options": opts}
    path = root / "c.yaml"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture()
def twins(tmp_path):
    return {name: (tmp_path / name, workspace(tmp_path / name))
            for name in ("jax", "port")}


def run(main, root: Path, cfg: Path, *flags) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(["--config", str(cfg), *flags]) == 0
    return out.getvalue().replace(str(root), "<root>")


def both(twins, *flags) -> tuple[str, str]:
    return (run(jmain, *twins["jax"], *flags),
            run(tmain, *twins["port"], *flags))


def tree(root: Path) -> dict:
    """Every file under ``root``: relative path → bytes (CSV text with the
    root replaced)."""
    out = {}
    for f in sorted(root.rglob("*")):
        if f.is_file():
            data = f.read_bytes()
            if f.name == "shard_index.json":
                # the fingerprint digests the paths, which name the root
                index = json.loads(data)
                del index["manifest_sha1"]
                data = json.dumps(index).encode()
            if f.suffix in (".csv", ".json", ".yaml"):
                data = data.replace(str(root).encode(), b"<root>")
            out[str(f.relative_to(root))] = data
    return out


def same_trees(twins) -> None:
    j, t = tree(twins["jax"][0]), tree(twins["port"][0])
    assert j.keys() == t.keys()
    for k in j:
        assert j[k] == t[k], k


@pytest.mark.parametrize("flags", [
    ["--generate"], ["--stats"], ["--filter"], ["--vad"], ["--restore"],
    ["--split_musan"], ["--convert"]],
    ids=["generate", "stats", "filter", "vad", "restore", "split_musan",
         "convert"])
def test_cli_flag_matches_jax(twins, flags):
    if flags == ["--convert"]:
        for root, _ in twins.values():
            for ext in ("m4a", "flac"):
                (root / "data" / "spk0" / f"x.{ext}").write_bytes(b"\0" * 64)
    if flags == ["--restore"]:
        both(twins, "--vad")                 # files for restore to remove
    jout, tout = both(twins, *flags)
    assert tout == jout
    assert tout.strip()
    same_trees(twins)
    if flags == ["--vad"]:
        assert len(list((twins["port"][0] / "data").rglob("*_vad.wav"))) > 0
    if flags == ["--restore"]:
        assert "removed" in tout and "removed 0" not in tout
        assert not list((twins["port"][0] / "data").rglob("*_vad.wav"))
        assert (twins["port"][0] / "data" / "spk2"
                / "interview_augmented.wav").exists()
    if flags == ["--filter"]:
        moved = json.loads(tout)["n_moved"]
        assert moved == 2, tout           # the quiet and the short file
    if flags == ["--convert"]:
        assert json.loads(tout)["failed"] == 2


@pytest.mark.parametrize("flags", [["--augment"], ["--pack", "PACK"]],
                         ids=["augment", "pack"])
def test_cli_flags_on_a_manifest_match_jax(twins, flags):
    """``--generate`` first, then the flag that reads the train manifest."""
    both(twins, "--generate")
    outs = []
    for name, main in (("jax", jmain), ("port", tmain)):
        root, cfg = twins[name]
        args = [str(root / "packed") if f == "PACK" else f for f in flags]
        outs.append(run(main, root, cfg, *args))
    assert outs[0] == outs[1]
    if flags[0] == "--augment":
        assert "augmented: 9 files" in outs[1], outs[1]
    else:
        assert json.loads(outs[1].strip().splitlines()[-1])["utts"] == 9
        from speakerverification_tpu_torch.data.manifest import Manifest
        from speakerverification_tpu_torch.data.shards import (
            INDEX_NAME,
            manifest_fingerprint,
        )
        for root, _ in twins.values():
            index = json.loads((root / "packed" / INDEX_NAME).read_text())
            assert index["manifest_sha1"] == manifest_fingerprint(
                Manifest.read(root / "meta" / "train.csv").paths)
    same_trees(twins)


@pytest.mark.parametrize("kind", ["zip", "tar"])
def test_cli_extract_matches_jax(twins, kind):
    for root, _ in twins.values():
        src = {"inner/a.txt": b"alpha", "inner/b/c.bin": bytes(range(50))}
        path = root / f"arch.{'zip' if kind == 'zip' else 'tar.gz'}"
        if kind == "zip":
            with zipfile.ZipFile(path, "w") as zf:
                for name, data in src.items():
                    zf.writestr(name, data)
        else:
            with tarfile.open(path, "w:gz") as tf:
                for name, data in src.items():
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    info.mtime = 0
                    tf.addfile(info, io.BytesIO(data))
    outs = [run(main, root, cfg, "--extract",
                str(root / f"arch.{'zip' if kind == 'zip' else 'tar.gz'}"))
            for main, (root, cfg) in ((jmain, twins["jax"]),
                                      (tmain, twins["port"]))]
    assert outs[0] == outs[1]
    assert (twins["port"][0] / "data" / "inner" / "b" / "c.bin").read_bytes() \
        == bytes(range(50))
    same_trees(twins)


def test_cli_download_of_a_present_file_is_cached(twins, monkeypatch):
    def no_network(*a, **k):
        raise AssertionError(f"a subprocess was started: {a}")
    monkeypatch.setattr(jdp.subprocess, "run", no_network)
    monkeypatch.setattr(tdp.subprocess, "run", no_network)
    for root, _ in twins.values():
        part = root / "data" / "vox1_part.zip"
        part.write_bytes(b"part of an archive")
        (root / "lines.txt").write_text(
            f"http://mirror.invalid/vox1_part.zip {tdp.md5(part)}\n")
    outs = [run(main, root, cfg, "--download", str(root / "lines.txt"))
            for main, (root, cfg) in ((jmain, twins["jax"]),
                                      (tmain, twins["port"]))]
    assert outs[0] == outs[1]
    assert outs[1].strip().endswith(": cached")


def test_cli_takes_every_jax_flag():
    from speakerverification_tpu_torch.cli.dataprep import build_parser
    port = {a.dest: (a.option_strings, a.default, a.nargs, a.type)
            for a in build_parser()._actions}
    import argparse
    import speakerverification_tpu.cli.dataprep as jcli
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        seen.update({a.dest: (a.option_strings, a.default, a.nargs, a.type)
                     for a in self._actions})
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jcli.main(["--config", "x"])
    finally:
        argparse.ArgumentParser.parse_args = real
    assert list(seen) == list(port) and seen == port


# ---------------------------------------------------------------------------
# function by function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_vad_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(mode)
    audio = np.concatenate([rng.normal(0, 0.002, SR),
                            _speech(rng, 2.0, 220),
                            rng.normal(0, 0.002, SR // 2)]).astype(np.float32)
    j, t = jvad.VAD(mode=mode), tvad.VAD(mode=mode)
    assert j._webrtc is None and t._webrtc is None   # not installed
    jd, jn = j._frame_decisions(audio, SR)
    td, tn = t._frame_decisions(audio, SR)
    assert jn == tn and np.array_equal(jd, td)
    js, ts = j.collect_segments(audio, SR), t.collect_segments(audio, SR)
    assert len(js) == len(ts) >= 1
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)
    write_wav(tmp_path / "a.wav", audio, SR)
    out_t = t.apply_to_file(tmp_path / "a.wav", tmp_path / "t.wav")
    out_j = j.apply_to_file(tmp_path / "a.wav", tmp_path / "j.wav")
    assert out_t.read_bytes() == out_j.read_bytes()
    write_wav(tmp_path / "silent.wav", np.zeros(SR, np.float32), SR)
    assert t.apply_to_file(tmp_path / "silent.wav") is None
    assert j.apply_to_file(tmp_path / "silent.wav") is None


def test_quality_matches_jax(tmp_path):
    root = tmp_path / "ws"
    workspace(root)
    data = root / "data"
    for f in sorted(data.rglob("*.wav"))[:4]:
        assert tq.audio_stats(f) == jq.audio_stats(f)
    write_wav(data / "empty.wav", np.zeros(0, np.float32), SR)
    assert tq.audio_stats(data / "empty.wav") == \
        jq.audio_stats(data / "empty.wav")
    got = tq.dataset_statistics(data, save_json=tmp_path / "t.json")
    want = jq.dataset_statistics(data, save_json=tmp_path / "j.json")
    assert got == want
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert tq.dataset_statistics(data, limit=3) == \
        jq.dataset_statistics(data, limit=3)
    bl = tmp_path / "bl.txt"
    bl.write_text(f"# comment\n{data / 'spk0' / 'u1.wav'} reason\n\n")
    assert tq.read_blacklist(bl) == jq.read_blacklist(bl) != set()
    assert tq.read_blacklist(tmp_path / "none") == set()
    kw = dict(blacklist=tq.read_blacklist(bl), dry_run=True)
    assert tq.filter_low_quality(data, tmp_path / "qt", **kw) == \
        jq.filter_low_quality(data, tmp_path / "qj", **kw)
    twin = tmp_path / "twin"
    workspace(twin)
    write_wav(twin / "data" / "empty.wav", np.zeros(0, np.float32), SR)
    got = tq.filter_low_quality(root / "data", tmp_path / "q1",
                                blacklist=tq.read_blacklist(bl))
    jbl = {str(twin / "data" / "spk0" / "u1.wav")}
    want = jq.filter_low_quality(twin / "data", tmp_path / "q2",
                                 blacklist=jbl)
    # the quiet, short, empty and blacklisted files
    assert got["n_moved"] == want["n_moved"] == 4
    assert got["n_kept"] == want["n_kept"]
    assert tree(tmp_path / "q1") == tree(tmp_path / "q2")


def test_wav_conversion_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.4, 1.4, 999).astype(np.float32)
    np.testing.assert_array_equal(twc.np_to_pcm16(x), jwc.np_to_pcm16(x))
    pcm = twc.np_to_pcm16(x)
    for norm in (True, False):
        got, want = twc.pcm16_to_np(pcm, norm), jwc.pcm16_to_np(pcm, norm)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twc.normalize_audio_amp(x),
                                  jwc.normalize_audio_amp(x))
    src = tmp_path / "s.wav"
    write_wav(src, 0.5 * x, SR)
    assert twc.convert_audio_shell(src, tmp_path / "o.wav",
                                   codec="no-such-codec") is \
        jwc.convert_audio_shell(src, tmp_path / "o2.wav",
                                codec="no-such-codec") is False
    for rate in (16000, 8000, 11025):
        twc.resample_file(src, tmp_path / f"t{rate}.wav", rate)
        jwc.resample_file(src, tmp_path / f"j{rate}.wav", rate)
        assert (tmp_path / f"t{rate}.wav").read_bytes() == \
            (tmp_path / f"j{rate}.wav").read_bytes()
        assert read_wav(tmp_path / f"t{rate}.wav")[1] == rate


def test_dataprep_functions_match_jax(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(bytes(range(256)) * 1000)
    assert tdp.md5(f) == jdp.md5(f)
    for root in (tmp_path / "t", tmp_path / "j"):
        root.mkdir()
        for i in range(3):
            (root / f"vox_part{'abc'[i]}").write_bytes(bytes([i]) * 10)
        (root / "cat.txt").write_text("vox_part* 0123\nshort\n")
    got = tdp.concatenate(tmp_path / "t", tmp_path / "t" / "cat.txt")
    want = jdp.concatenate(tmp_path / "j", tmp_path / "j" / "cat.txt")
    assert [s for _, s in got] == [s for _, s in want] == ["checksum mismatch"]
    assert (tmp_path / "t" / "vox").read_bytes() == \
        (tmp_path / "j" / "vox").read_bytes() == b"\0" * 10 + b"\1" * 10 \
        + b"\2" * 10
    ok = f"vox_part* {tdp.md5(tmp_path / 't' / 'vox')}\n"
    (tmp_path / "t" / "ok.txt").write_text(ok)
    assert tdp.concatenate(tmp_path / "t", tmp_path / "t" / "ok.txt")[0][1] \
        == "ok"
    for root in (tmp_path / "t", tmp_path / "j"):
        for name in ("a_vad.wav", "b_aug0.wav", "c_aug12.wav",
                     "interview_augmented.wav", "vad_notes.wav", "d.wav"):
            write_wav(root / "x" / name, np.zeros(10, np.float32), SR)
    assert tdp.restore_dataset(tmp_path / "t") == \
        jdp.restore_dataset(tmp_path / "j") == 3
    assert sorted(p.name for p in (tmp_path / "t" / "x").iterdir()) == \
        ["d.wav", "interview_augmented.wav", "vad_notes.wav"]


def test_offline_augmentation_bytes_match_jax(tmp_path):
    opts = write_noise_corpus(tmp_path / "aug")
    rng = np.random.default_rng(9)
    paths = []
    for i in range(6):
        p = tmp_path / "data" / f"spk{i % 2}" / f"u{i}.wav"
        write_wav(p, rng.normal(0, 0.2, 5000).astype(np.float32), SR)
        paths.append(str(p))
    spec = {"sample_rate": SR, "sentence_len": 0.5}
    n_t = tdp.offline_augmentation(paths, opts, spec, tmp_path / "t")
    n_j = jdp.offline_augmentation(paths, opts, spec, tmp_path / "j")
    assert n_t == n_j == 6
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
