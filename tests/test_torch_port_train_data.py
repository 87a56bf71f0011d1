"""The port's training data path against the JAX package's (CPU):
manifests, the speaker-balanced sampler and the training loader give
the same files, labels and crops — byte for byte — from the same
synthetic WAVs and seed; the options the port does not take are refused
by name."""

import threading
import time

import numpy as np
import pytest

from speakerverification_tpu.data import audio as jaudio
from speakerverification_tpu.data.loader import (
    train_data_loader as j_train_loader,
)
from speakerverification_tpu.data.manifest import (
    Manifest as JManifest,
    generate_metadata as j_generate,
)
from speakerverification_tpu.data.sampler import (
    SpeakerBatchSampler as JSampler,
)
from speakerverification_tpu_torch.data import audio as taudio
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.data.loader import (
    train_data_loader as t_train_loader,
)
from speakerverification_tpu_torch.data.manifest import (
    Manifest,
    generate_metadata,
)
from speakerverification_tpu_torch.data.sampler import SpeakerBatchSampler

SR = 8000


def _corpus(root, n_spk=7, n_utt=5, seed=0):
    rng = np.random.default_rng(seed)
    for s in range(n_spk):
        for u in range(n_utt):
            seconds = rng.uniform(0.3, 1.6)      # shorter and longer crops
            x = 0.3 * rng.normal(0, 1, int(seconds * SR))
            write_wav(root / f"spk{s:02d}" / f"u{u}.wav",
                      np.clip(x, -1, 1), SR)
    return root


def test_generate_metadata_matches_jax(tmp_path):
    data = _corpus(tmp_path / "data")
    got = generate_metadata(data, tmp_path / "port", seed=3)
    want = j_generate(data, tmp_path / "jax", seed=3)
    assert got == want
    for name in ("train.csv", "dev.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    m, jm = (Manifest.read(tmp_path / "port" / "train.csv"),
             JManifest.read(tmp_path / "jax" / "train.csv"))
    assert (m.paths, m.labels, m.speakers) == (jm.paths, jm.labels,
                                               jm.speakers)
    assert m.num_classes == 7


@pytest.mark.parametrize("batch,n_per,max_seg,epoch",
                         [(4, 2, 500, 1), (3, 1, 2, 2), (5, 2, 4, 7)])
def test_sampler_matches_jax(batch, n_per, max_seg, epoch):
    labels = np.random.default_rng(1).integers(0, 9, 80)
    got = SpeakerBatchSampler(labels, batch, n_per, max_seg, seed=5)
    want = JSampler(labels, batch, n_per, max_seg, seed=5)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert list(got) == list(want)
    assert len(got) == len(want)


def test_train_crops_match_jax(tmp_path):
    data = _corpus(tmp_path / "data", n_spk=2, n_utt=2)
    spec = {"sample_rate": SR, "sentence_len": 0.5}
    for path in sorted(str(p) for p in data.rglob("*.wav")):
        for random_chunk in (True, False):
            got = taudio.load_wav(path, spec, evalmode=False,
                                  random_chunk=random_chunk,
                                  rng=np.random.default_rng(4))
            want = jaudio.load_wav(path, spec, evalmode=False,
                                   random_chunk=random_chunk,
                                   rng=np.random.default_rng(4))
            assert got.shape == (1, 4000)
            assert np.array_equal(got, want)


def _hparams(tmp_path, **extra):
    data = _corpus(tmp_path / "data")
    generate_metadata(data, tmp_path / "meta", seed=0)
    return {"train_annotation": str(tmp_path / "meta" / "train.csv"),
            "audio_spec": {"sample_rate": SR, "sentence_len": 0.5},
            "seed": 11, "random_chunk": True,
            "dataloader_options": {"batch_size": 3, "nPerSpeaker": 2,
                                   "max_seg_per_spk": 500,
                                   "num_workers": 2}, **extra}


def test_train_loader_batches_match_jax_byte_for_byte(tmp_path):
    h = _hparams(tmp_path)
    got, want = t_train_loader(h), j_train_loader(h)
    assert len(got) == len(want) > 0
    for epoch in (1, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got, want))
        assert len(pairs) == len(want)
        for g, w in pairs:
            assert g["wave"].shape == (3, 2, 4000)
            assert g["wave"].dtype == np.float32
            assert g["wave"].tobytes() == w["wave"].tobytes()
            assert np.array_equal(g["label"], w["label"])
            assert g["label"].dtype == np.int32


def test_train_loader_stops_its_producer_when_left_early(tmp_path):
    loader = t_train_loader(_hparams(tmp_path))
    it = iter(loader)
    next(it)
    it.close()                        # the producer thread winds down
    assert len(list(loader)) == len(loader)


def test_train_loader_ends_behind_a_slow_consumer(tmp_path):
    """A consumer slower than the producer finds the prefetch queue full
    when the producer finishes: the end of the epoch still arrives after
    the last batch (it was dropped, and the consumer waited forever)."""
    loader = t_train_loader(_hparams(tmp_path))
    loader.prefetch = 1
    seen = 0
    done = threading.Event()

    def consume():
        nonlocal seen
        for _ in loader:
            time.sleep(0.2)
            seen += 1
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert done.is_set() and not t.is_alive()
    assert seen == len(loader) > 1


@pytest.mark.parametrize("extra,error,match", [
    ({"dataloader_options": {"shards": "packs/"}}, FileNotFoundError,
     "shard_index.json")],
    ids=["extra1"])
def test_unported_data_options_are_refused(tmp_path, extra, error, match):
    """Packed shards are ported: a ``shards`` directory that holds no pack
    is refused by name."""
    h = _hparams(tmp_path)
    if "dataloader_options" in extra:
        extra = {"dataloader_options": {**h["dataloader_options"],
                                        **extra["dataloader_options"]}}
    with pytest.raises(error, match=match):
        t_train_loader({**h, **extra})


def test_too_few_speakers_for_a_batch_raise(tmp_path):
    h = _hparams(tmp_path)
    h["dataloader_options"] = {**h["dataloader_options"], "batch_size": 50}
    with pytest.raises(ValueError, match="zero batches"):
        t_train_loader(h)
