"""Packed shards (``data/shards.py``) and the shard-fed loader, against the
JAX package.

* A pack from the port equals a pack from JAX: the index JSON and every
  shard's bytes (16-bit sources, and a float32 and a stereo one, which
  are requantized at pack time).
* Each package loads the other's pack.
* ``crop_train`` is byte-identical to the file path with the same
  generator; ``crops_eval`` matches ``load_wav``'s eval crops.
* The port's loader fed by shards equals the port's loader fed by the
  WAV files and the JAX loader fed by the same shards, batch for batch
  over two epochs: without augmentation on two threads, and with the
  host chain (env_corrupt and the time domain without pitch, whose
  vocoder differs in the last bits) on one thread.
* The three refusals (sample rate, length, manifest) raise ValueError.
* ``dataloader_options.shards`` reaches the loader, and a small Trainer
  takes its steps from shards on the CPU.
"""

import json

import numpy as np
import pytest

from speakerverification_tpu.data import shards as jshards
from speakerverification_tpu.data.loader import TrainDataLoader as JLoader
from speakerverification_tpu.data.manifest import Manifest as JManifest
from speakerverification_tpu_torch.data import loader as tloader
from speakerverification_tpu_torch.data import shards as tshards
from speakerverification_tpu_torch.data.audio import load_wav, write_wav
from speakerverification_tpu_torch.data.manifest import Manifest

from test_torch_port_augment_helpers import write_noise_corpus

SR = 8000
SPEC = {"sample_rate": SR, "channels": 1, "sentence_len": 0.5,
        "win_len": 0.025, "hop_len": 0.01}                 # 4,000 samples


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 speakers x 3 utterances whose lengths straddle the crop (short:
    pad-wrap; the crop's length; long), one of them float32 and one
    stereo; packed by both packages with a 1 MiB cap."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for spk in range(6):
        for u, n in enumerate((2500, 4000, 9000 + 700 * spk)):
            sig = (0.25 * np.sin(np.arange(n) * (0.02 + 0.003 * spk))
                   + rng.normal(0, 0.05, n)).astype(np.float32)
            p = root / "raw" / f"s{spk}" / f"u{u}.wav"
            if (spk, u) == (1, 2):
                write_wav(p, sig, SR, subtype="FLOAT")
            elif (spk, u) == (2, 2):
                write_wav(p, np.stack([sig, -0.5 * sig], 1), SR)
            else:
                write_wav(p, sig, SR)
            paths.append(str(p))
            labels.append(spk)
    manifest = Manifest(paths=paths, labels=labels, speakers=list(range(6)))
    jmanifest = JManifest(paths=paths, labels=labels, speakers=list(range(6)))
    stats = {"port": tshards.pack_shards(manifest, root / "tpack",
                                         shard_mb=1, sample_rate=SR),
             "jax": jshards.pack_shards(jmanifest, root / "jpack",
                                        shard_mb=1, sample_rate=SR)}
    return root, manifest, jmanifest, stats


def test_pack_equals_jax_pack(corpus):
    root, manifest, _, stats = corpus
    assert stats["port"] == stats["jax"]
    assert stats["port"]["utts"] == 18 and stats["port"]["requantized"] == 2
    tidx = json.loads((root / "tpack" / tshards.INDEX_NAME).read_text())
    jidx = json.loads((root / "jpack" / jshards.INDEX_NAME).read_text())
    assert tidx == jidx
    assert [u[4] for u in tidx["utts"]] == manifest.paths
    assert tidx["manifest_sha1"] == tshards.manifest_fingerprint(
        manifest.paths) == jshards.manifest_fingerprint(manifest.paths)
    for name in tidx["shards"]:
        assert (root / "tpack" / name).read_bytes() == \
            (root / "jpack" / name).read_bytes()


def test_pack_splits_at_the_cap(tmp_path):
    """Shards hold at most ``shard_mb``: a 0-MiB cap gives one file per
    utterance, as the JAX package splits them."""
    paths = []
    for i in range(3):
        p = tmp_path / f"u{i}.wav"
        write_wav(p, np.full(100 + i, 0.1, np.float32), SR)
        paths.append(str(p))
    m = Manifest(paths=paths, labels=[0, 1, 2], speakers=[0, 1, 2])
    jm = JManifest(paths=paths, labels=[0, 1, 2], speakers=[0, 1, 2])
    got = tshards.pack_shards(m, tmp_path / "t", shard_mb=0)
    want = jshards.pack_shards(jm, tmp_path / "j", shard_mb=0)
    assert got == want and got["shards"] == 3
    assert (tmp_path / "t" / tshards.INDEX_NAME).read_text() == \
        (tmp_path / "j" / jshards.INDEX_NAME).read_text()


def test_each_package_loads_the_others_pack(corpus):
    root, manifest, _, _ = corpus
    t_of_j = tshards.ShardedAudioSource(root / "jpack")
    j_of_t = jshards.ShardedAudioSource(root / "tpack")
    assert len(t_of_j) == len(j_of_t) == len(manifest)
    assert t_of_j.sample_rate == j_of_t.sample_rate == SR
    for i in range(len(manifest)):
        np.testing.assert_array_equal(t_of_j.load(i), j_of_t.load(i))
        assert t_of_j.label(i) == j_of_t.label(i) == manifest.labels[i]
        assert t_of_j.index_of(manifest.paths[i]) == i
    np.testing.assert_array_equal(t_of_j.load(manifest.paths[5]),
                                  j_of_t.load(5))


def test_crops_match_the_file_path(corpus):
    root, manifest, _, _ = corpus
    src = tshards.ShardedAudioSource(root / "tpack")
    jsrc = jshards.ShardedAudioSource(root / "tpack")
    requantized = {manifest.paths.index(str(root / "raw" / s / "u2.wav"))
                   for s in ("s1", "s2")}
    for i in range(len(manifest)):
        for seed in (1, 2):
            got = src.crop_train(i, SPEC, rng=np.random.default_rng(seed))
            want = jsrc.crop_train(i, SPEC, rng=np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
            from_file = load_wav(manifest.paths[i], SPEC, evalmode=False,
                                 rng=np.random.default_rng(seed))
            assert got.shape == from_file.shape == (1, 4000)
            if i in requantized:
                np.testing.assert_allclose(got, from_file, atol=0.5 / 32768)
            else:
                np.testing.assert_array_equal(got, from_file)
        np.testing.assert_array_equal(
            src.crop_train(i, SPEC, random_chunk=False),
            jsrc.crop_train(i, SPEC, random_chunk=False))
        for num_eval in (0, 3):
            got = src.crops_eval(i, SPEC, num_eval=num_eval)
            np.testing.assert_array_equal(
                got, jsrc.crops_eval(i, SPEC, num_eval=num_eval))
            if i not in requantized:
                np.testing.assert_array_equal(got, load_wav(
                    manifest.paths[i], SPEC, num_eval=num_eval))


def _augment_options(root) -> dict:
    opts = write_noise_corpus(root / "noise")
    return {**opts, "augment_time_domain": {
        **opts["augment_time_domain"], "proportion": [0.4, 0.0, 0.3]}}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "host"])
def test_shard_loader_equals_file_loader_and_jax(corpus, tmp_path, augment):
    root, manifest, jmanifest, _ = corpus
    kw = dict(audio_spec=SPEC, batch_size=3, nPerSpeaker=2, seed=7,
              num_workers=1 if augment else 2)
    if augment:
        opts = _augment_options(tmp_path)
        kw.update(augment=True, augment_options=opts)
    tsrc = tshards.ShardedAudioSource(root / "tpack")
    jsrc = jshards.ShardedAudioSource(root / "tpack")
    shard = tloader.TrainDataLoader(manifest=manifest, shard_source=tsrc,
                                    **kw)
    files = tloader.TrainDataLoader(manifest=manifest, **kw)
    jax_ = JLoader(manifest=jmanifest, shard_source=jsrc, **kw)
    assert (shard.augmentor is not None) == augment
    n = 0
    for epoch in (1, 2):
        for ld in (shard, files, jax_):
            ld.set_epoch(epoch)
        for sb, fb, jb in zip(shard, files, jax_):
            np.testing.assert_array_equal(sb["label"], jb["label"])
            np.testing.assert_array_equal(sb["label"], fb["label"])
            np.testing.assert_array_equal(sb["wave"], jb["wave"])
            # the two requantized files differ by at most half a step
            np.testing.assert_allclose(sb["wave"], fb["wave"],
                                       atol=0.5 / 32768 * 4, rtol=0)
            n += 1
    assert n == 2 * len(shard) >= 4


def test_shard_loader_equals_file_loader_exactly_on_16_bit(corpus, tmp_path):
    """Without the requantized files the shard batches are the file
    batches bit for bit."""
    root, manifest, _, _ = corpus
    keep = [i for i, p in enumerate(manifest.paths)
            if not p.endswith(("s1/u2.wav", "s2/u2.wav"))]
    m = Manifest(paths=[manifest.paths[i] for i in keep],
                 labels=[manifest.labels[i] for i in keep],
                 speakers=manifest.speakers)
    tshards.pack_shards(m, tmp_path / "pack")
    kw = dict(manifest=m, audio_spec=SPEC, batch_size=3, nPerSpeaker=2,
              seed=4, num_workers=2)
    shard = tloader.TrainDataLoader(
        shard_source=tshards.ShardedAudioSource(tmp_path / "pack"), **kw)
    files = tloader.TrainDataLoader(**kw)
    for sb, fb in zip(shard, files):
        np.testing.assert_array_equal(sb["wave"], fb["wave"])


@pytest.mark.parametrize("mismatch", ["sample_rate", "length", "manifest"])
def test_loader_refuses_a_pack_of_another_corpus(corpus, mismatch):
    root, manifest, _, _ = corpus
    src = tshards.ShardedAudioSource(root / "tpack")
    spec, m = SPEC, manifest
    if mismatch == "sample_rate":
        spec, match = {**SPEC, "sample_rate": 16000}, "8000 Hz"
    elif mismatch == "length":
        m = Manifest(paths=manifest.paths[:12], labels=manifest.labels[:12],
                     speakers=manifest.speakers)
        match = "repack"
    else:
        # the same length, two paths swapped: only the fingerprint sees it
        paths = list(manifest.paths)
        paths[3], paths[7] = paths[7], paths[3]
        m = Manifest(paths=paths, labels=manifest.labels,
                     speakers=manifest.speakers)
        match = "different manifest"
    with pytest.raises(ValueError, match=match):
        tloader.TrainDataLoader(manifest=m, audio_spec=spec, batch_size=2,
                                nPerSpeaker=2, shard_source=src)


def test_pack_refusals(corpus, tmp_path):
    _, manifest, _, _ = corpus
    with pytest.raises(ValueError, match="sample rate"):
        tshards.pack_shards(manifest, tmp_path / "bad", sample_rate=16000)
    with pytest.raises(ValueError, match="nothing to pack"):
        tshards.pack_shards(Manifest(paths=[], labels=[], speakers=[]),
                            tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        tshards.ShardedAudioSource(tmp_path / "nope")
    (tmp_path / "v2").mkdir()
    (tmp_path / "v2" / tshards.INDEX_NAME).write_text('{"version": 2}')
    with pytest.raises(ValueError, match="version"):
        tshards.ShardedAudioSource(tmp_path / "v2")


def test_train_data_loader_wiring(corpus, tmp_path):
    root, manifest, _, _ = corpus
    csv = tmp_path / "train.csv"
    Manifest.write(csv, [[f"s{lab}", p] for p, lab in
                         zip(manifest.paths, manifest.labels)])
    h = {"train_annotation": str(csv), "audio_spec": SPEC, "seed": 7,
         "dataloader_options": {"batch_size": 3, "nPerSpeaker": 2,
                                "shards": str(root / "tpack")}}
    loader = tloader.train_data_loader(h)
    assert isinstance(loader.shard_source, tshards.ShardedAudioSource)
    batch = next(iter(loader))
    assert batch["wave"].shape == (3, 2, 4000)
    assert np.isfinite(batch["wave"]).all()
    h["dataloader_options"] = {"batch_size": 3, "nPerSpeaker": 2}
    assert tloader.train_data_loader(h).shard_source is None


def test_trainer_steps_from_shards_on_the_cpu(tmp_path):
    from speakerverification_tpu_torch.data.manifest import generate_metadata
    from speakerverification_tpu_torch.training.trainer import Trainer
    rng = np.random.default_rng(5)
    for spk in range(4):
        for u in range(5):
            tt = np.arange(int(0.8 * SR)) / SR
            sig = 0.3 * np.sin(2 * np.pi * (150 + 60 * spk) * tt) \
                + rng.normal(0, 0.02, tt.size)
            write_wav(tmp_path / "data" / f"spk{spk}" / f"u{u}.wav",
                      sig.astype(np.float32), SR)
    generate_metadata(tmp_path / "data", tmp_path / "meta", seed=3)
    manifest = Manifest.read(tmp_path / "meta" / "train.csv")
    tshards.pack_shards(manifest, tmp_path / "pack")
    h = {"seed": 3, "save_folder": str(tmp_path / "save"),
         "data_folder": str(tmp_path / "data"),
         "train_annotation": str(tmp_path / "meta" / "train.csv"),
         "audio_spec": SPEC, "n_mels": 40, "features": "melspectrogram",
         "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                   "nOut": 16, "channels": [16, 16, 16, 16, 48],
                   "attention_channels": 4, "res2net_scale": 2,
                   "se_channels": 4},
         "nClasses": 4, "lr": 0.003, "number_of_epochs": 1, "batch_size": 2,
         "criterion": {"name": "AAmSoftmax", "margin": 0.2, "scale": 30},
         "optimizer": {"name": "adam"},
         "dataloader_options": {"batch_size": 2, "nPerSpeaker": 2,
                                "num_workers": 1,
                                "shards": str(tmp_path / "pack")}}
    trainer = Trainer(h, device="cpu")
    assert trainer.loader.shard_source is not None
    result = trainer.fit()
    assert result["state"].step == len(trainer.loader) >= 1
    assert np.isfinite(result["min_loss"])
    assert (tmp_path / "save" / "ECAPA_TDNN" / "AAmSoftmax" / "model"
            / "last_state.msgpack").exists()
