"""Host augmentation, port against the JAX package (CPU): ``load_wav``'s
``load_all`` and ``normalize``, the phase vocoder, ``AugmentWav``'s
``env_corrupt``, the time-domain chain and the augmented training
loader, on a small synthetic corpus in MUSAN / RIRS_NOISES' layout.

Everything but pitch is numpy and scipy in both packages with the same
draws from the same generator, so it is held bit for bit. The port's
phase vocoder computes in float64 where JAX's runs in float32 (its
phase increments summed in float32): on unit-peak audio the two differ
by at most 1.1e-3 (measured over 15 shifts and 2 stretches of three
8 kHz signals), so pitch rows are held within 2e-3.
"""

import numpy as np
import pytest

from speakerverification_tpu.data import audio as j_audio
from speakerverification_tpu.data import augment as j_augment
from speakerverification_tpu.data.loader import (
    train_data_loader as j_train_loader,
)
from speakerverification_tpu.ops import phase_vocoder as j_pv
from speakerverification_tpu_torch.data import audio as t_audio
from speakerverification_tpu_torch.data import augment as t_augment
from speakerverification_tpu_torch.data import loader as t_loader
from speakerverification_tpu_torch.data.manifest import Manifest
from speakerverification_tpu_torch.ops import phase_vocoder as t_pv

from test_torch_port_augment_helpers import SPEC, SR, write_noise_corpus

PITCH_TOL = 2e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("augment_corpus")
    return root, write_noise_corpus(root)


def unit_peak(seed: int, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / SR
    y = (0.5 * np.sin(2 * np.pi * 220 * tt) + 0.3 * rng.normal(0, 1, n))
    return (y / np.abs(y).max()).astype(np.float32)


# ---------------------------------------------------------------------------
# load_wav
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [True, False])
def test_load_wav_recrop_with_and_without_normalize(normalize):
    audio = 0.3 * unit_peak(1, 4200)
    for seed in range(3):
        got = t_audio.load_wav(audio, SPEC, evalmode=False,
                               rng=np.random.default_rng(seed),
                               normalize=normalize)
        want = j_audio.load_wav(audio, SPEC, evalmode=False,
                                rng=np.random.default_rng(seed),
                                normalize=normalize)
        np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() == pytest.approx(1.0 if normalize else 0.3,
                                              abs=0.02)


def test_load_wav_load_all_reads_the_whole_file(corpus):
    root, _ = corpus
    path = str(root / "RIRS_NOISES" / "simulated_rirs" / "room0" / "R0"
               / "r.wav")
    got = t_audio.load_wav(path, SPEC, load_all=True)
    np.testing.assert_array_equal(got, j_audio.load_wav(path, SPEC,
                                                        load_all=True))
    assert got.shape == (1, 700)


# ---------------------------------------------------------------------------
# the phase vocoder
# ---------------------------------------------------------------------------

def test_stft_and_istft_match_jax():
    y = unit_peak(2, 6000)
    D = t_pv.stft(y)
    jD = np.asarray(j_pv.stft(y))
    assert D.shape == jD.shape
    assert np.abs(D - jD).max() <= 1e-6 * np.abs(jD).max()
    back = t_pv.istft(D, length=y.size)
    np.testing.assert_allclose(back, y, atol=1e-6)
    np.testing.assert_allclose(
        back, np.asarray(j_pv.istft(j_pv.stft(y), length=y.size)), atol=1e-6)


@pytest.mark.parametrize("rate", [0.9, 1.1])
def test_time_stretch_matches_jax(rate):
    y = unit_peak(3, 8000)
    got = t_pv.time_stretch(y, rate)
    want = np.asarray(j_pv.time_stretch(y, rate=rate))
    assert got.shape == want.shape == (int(round(8000 / rate)),)
    assert np.abs(got - want).max() <= PITCH_TOL


@pytest.mark.parametrize("n_steps", [-0.5, -0.2, 0.05, 0.35, 0.5])
def test_pitch_shift_matches_jax(n_steps):
    y = unit_peak(4, 8000)
    got = t_pv.pitch_shift(y, n_steps)
    want = np.asarray(j_pv.pitch_shift(y, 16000, n_steps))
    assert got.shape == want.shape == y.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= PITCH_TOL


# ---------------------------------------------------------------------------
# AugmentWav and the time-domain chain
# ---------------------------------------------------------------------------

def engines(opts):
    """The JAX engine draws from its ``rng`` attribute, which each test
    seeds; the port's draws from the generator passed to each call."""
    return j_augment.AugmentWav(opts, SPEC), t_augment.AugmentWav(opts, SPEC)


def test_file_lists_match_jax(corpus):
    _, opts = corpus
    j, p = engines(opts)
    assert p.noiselist == j.noiselist
    assert p.reverberation_files == j.reverberation_files
    assert sorted(p.noiselist) == ["music", "noise", "noise_rirs",
                                   "noise_vad", "speech"]


def test_env_corrupt_is_byte_identical(corpus):
    """40 seeds reach every branch (rev, noise of each category, both in
    each order, none); each is held bit for bit."""
    _, opts = corpus
    j, p = engines(opts)
    audio = (0.2 * unit_peak(5, 4000))[None, :]
    kinds = set()
    for seed in range(40):
        kinds.add(str(np.random.default_rng(seed).choice(
            t_augment.ENV_CORRUPT_TYPES, p=t_augment.ENV_CORRUPT_PROBS)))
        j.rng = np.random.default_rng(seed)
        want = j.env_corrupt(audio)
        got = p.env_corrupt(audio, np.random.default_rng(seed))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert kinds == {"rev", "noise", "both", "none"}


def test_env_corrupt_without_rirs_or_noise(corpus, tmp_path):
    """The fallbacks: no RIRs (rev and both become noise), no noise (every
    corruption reverberates)."""
    root, opts = corpus
    rir = root / "RIRS_NOISES" / "simulated_rirs" / "room0" / "R0" / "r.wav"
    only_rirs = tmp_path / "rirs_only" / "simulated_rirs" / "a" / "b"
    only_rirs.mkdir(parents=True)
    (only_rirs / "r.wav").write_bytes(rir.read_bytes())
    none = str(tmp_path / "none")
    audio = (0.2 * unit_peak(6, 4000))[None, :]
    for paths in ({**opts["augment_paths"], "rirs": none},
                  {"musan": none, "noise_vad": none,
                   "rirs": str(tmp_path / "rirs_only")}):
        j, p = engines({**opts, "augment_paths": paths})
        assert p.has_reverb != p.has_noise
        for seed in range(12):
            j.rng = np.random.default_rng(seed)
            np.testing.assert_array_equal(
                p.env_corrupt(audio, np.random.default_rng(seed)),
                j.env_corrupt(audio))


def _seed_for(choice: str, p) -> int:
    for seed in range(100):
        if np.random.default_rng(seed).choice(
                ["speed", "pitch", "volume", "none"], p=p) == choice:
            return seed
    raise AssertionError(choice)


@pytest.mark.parametrize("choice", ["speed", "pitch", "volume", "none"])
def test_time_domain_matches_jax(corpus, choice):
    _, opts = corpus
    setting = opts["augment_time_domain"]
    seed = _seed_for(choice, setting["proportion"] + [0.25])
    audio = (0.3 * unit_peak(7, 4000))[None, :]
    got = t_augment.random_time_domain_augment(
        audio, setting, rng=np.random.default_rng(seed))
    want = j_augment.random_time_domain_augment(
        audio, setting, rng=np.random.default_rng(seed))
    assert got.shape == want.shape
    if choice == "pitch":
        assert np.abs(got - want).max() <= PITCH_TOL
        assert np.abs(got - audio).max() > 1e-2        # it did shift
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the augmented training loader
# ---------------------------------------------------------------------------

def _train_hparams(tmp_path, opts, n_spk: int = 6, n_utt: int = 3):
    rng = np.random.default_rng(11)
    rows = []
    for s in range(n_spk):
        for u in range(n_utt):
            path = tmp_path / "data" / f"spk{s}" / f"u{u}.wav"
            n = int(rng.integers(3000, 7000))
            t_audio.write_wav(path, (0.2 * rng.normal(0, 1, n)).astype(
                np.float32), SR)
            rows.append([f"spk{s}", str(path), n / SR, "wav"])
    Manifest.write(tmp_path / "train.csv", rows)
    return {"train_annotation": str(tmp_path / "train.csv"),
            "audio_spec": SPEC, "seed": 3, "augment": True,
            "augment_options": opts,
            "dataloader_options": {"batch_size": 4, "nPerSpeaker": 2,
                                   "num_workers": 1}}


def test_augmented_loader_batches_match_jax(corpus, tmp_path, monkeypatch):
    """Two epochs of the host chain (time_domain then env_corrupt) from
    both loaders, one decode thread each (the JAX loader hands its one
    engine each tuple's generator through a shared attribute, which is
    only deterministic on one thread): every row equal bit for bit, or,
    for a crop that went through the pitch shift, within the pitch
    tolerance."""
    _, opts = corpus
    h = _train_hparams(tmp_path, opts)
    jl, tl = j_train_loader(h), t_loader.train_data_loader(h)
    assert tl.augmentor is not None
    shifted = []
    real = t_augment.augment_pitch

    def counted(audio, *a, **kw):
        out = real(audio, *a, **kw)
        shifted.append(not np.array_equal(out, audio))
        return out
    monkeypatch.setattr(t_augment, "augment_pitch", counted)
    exact = inexact = 0
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for jb, tb in zip(jl, tl):
            np.testing.assert_array_equal(tb["label"], jb["label"])
            for got, want in zip(tb["wave"].reshape(-1, 4000),
                                 jb["wave"].reshape(-1, 4000)):
                if np.array_equal(got, want):
                    exact += 1
                else:
                    inexact += 1
                    assert np.abs(got - want).max() <= PITCH_TOL
    assert inexact <= sum(shifted) and exact >= 8, (exact, inexact, shifted)


def test_augmented_loader_is_deterministic_across_threads(corpus, tmp_path):
    """The port passes each tuple's generator down the call, so four
    decode threads give one thread's batches."""
    _, opts = corpus
    h = _train_hparams(tmp_path, opts)
    one = [b["wave"] for b in t_loader.train_data_loader(h)]
    h4 = {**h, "dataloader_options": {**h["dataloader_options"],
                                      "num_workers": 4}}
    four = t_loader.train_data_loader(h4)
    four.num_workers = 4
    for a, b in zip(one, (b["wave"] for b in four)):
        np.testing.assert_array_equal(a, b)


def test_loader_without_env_corrupt_files_has_no_engine(tmp_path):
    """An ``env_corrupt`` chain over folders without files leaves the
    crops clean, as in JAX."""
    opts = {"augment_paths": {"musan": str(tmp_path / "m"),
                              "rirs": str(tmp_path / "r")},
            "augment_chain": ["env_corrupt"], "noise_snr": {},
            "noise_samples": {}}
    h = _train_hparams(tmp_path, opts)
    assert t_loader.train_data_loader(h).augmentor is None
    assert j_train_loader(h).augmentor is None
