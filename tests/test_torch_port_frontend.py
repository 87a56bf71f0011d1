"""Port frontend (mel, and since the tenth slice mfcc and spectrogram)
against the JAX package.

The port's plain frontend and the mel kernel's pipeline (on a CPU tensor
it runs the kernel's plain version) against JAX ``make_frontend`` and
``make_pallas_mel_frontend(..., interpret=True)``, at the 8 kHz and
16 kHz configs and at a frame count that fills neither the port's
64-frame block nor the TPU kernel's 256-row block.

Tolerance: 1e-5 of the largest mel value. Both sides are fp32 sums of
n_fft and n_fft/2+1 terms taken in different orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.ops import frontend as jf
from speakerverification_tpu.ops.pallas_frontend import make_pallas_mel_frontend
from speakerverification_tpu_torch.ops import frontend as tf
from speakerverification_tpu_torch.ops import mel_frontend as tmf

from test_torch_port_helpers import close, t

REL = 1e-5

CONFIGS = {
    "8k": dict(),
    "16k": dict(sample_rate=16000, win_length=400, hop_length=160,
                fmin=20.0, fmax=7600.0),
}


@pytest.mark.parametrize("name,samples", [("8k", 8000), ("16k", 16000),
                                          ("8k", 5127)])
def test_mel_frontend_matches_jax(name, samples):
    jcfg = jf.FrontendConfig(**CONFIGS[name])
    tcfg = tf.FrontendConfig(**CONFIGS[name])
    wave = (0.3 * np.random.default_rng(samples).normal(0, 1, (3, samples))
            ).astype(np.float32)
    ref = np.asarray(jf.make_frontend(jcfg)(jnp.asarray(wave)))
    ref_pallas = np.asarray(make_pallas_mel_frontend(
        jcfg, interpret=True)(jnp.asarray(wave)))
    assert ref.shape == (3, 1 + samples // tcfg.hop_length, 80)
    assert ref.shape[1] % 64 and ref.shape[1] % 256
    plain = tf.make_frontend(tcfg)(t(wave)).numpy()
    piped = tmf.make_mel_frontend(tcfg)(t(wave)).numpy()
    for got, what in ((plain, "plain"), (piped, "kernel pipeline")):
        close(got, ref, REL, f"{what} vs JAX make_frontend")
        close(got, ref_pallas, REL, f"{what} vs JAX pallas kernel")


def test_mel_frontend_keeps_batch_shape():
    wave = t(np.zeros((2, 3, 800), np.float32))
    cfg = tf.FrontendConfig()
    assert tf.make_frontend(cfg)(wave).shape == (2, 3, 11, 80)
    assert tmf.make_mel_frontend(cfg)(wave).shape == (2, 3, 11, 80)


HPARAMS = [
    {},
    {"audio_spec": {"sample_rate": 16000, "win_len": 0.025,
                    "hop_len": 0.01}, "fmin": 20.0, "fmax": 7600.0},
    {"sample_rate": 16000, "audio_spec": {"sample_rate": 8000}},
    {"n_fft": 256, "n_mels": 40, "win_length": 160, "hop_length": 40,
     "pre_emphasis": False},
]


@pytest.mark.parametrize("feature_type", ["melspectrogram", "mfcc", "raw"])
@pytest.mark.parametrize("idx", range(len(HPARAMS)))
def test_frontend_config_from_hparams(idx, feature_type):
    h = HPARAMS[idx]
    assert dataclasses.asdict(tf.FrontendConfig.from_hparams(h, feature_type)) \
        == dataclasses.asdict(jf.FrontendConfig.from_hparams(h, feature_type))


@pytest.mark.parametrize("name", ["8k", "16k"])
def test_constants_match(name):
    cfg = jf.FrontendConfig(**CONFIGS[name])
    K = cfg.n_fft // 2 + 1
    np.testing.assert_array_equal(
        tf.mel_filterbank(K, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax),
        jf.mel_filterbank(K, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax))
    for a, b in zip(tf.dft_matrices(cfg.n_fft, cfg.win_length),
                    jf.dft_matrices(cfg.n_fft, cfg.win_length)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf.frame_indices(1000, cfg.n_fft, cfg.hop_length),
                                  jf.frame_indices(1000, cfg.n_fft, cfg.hop_length))


def test_pre_emphasis_first_sample_reflects():
    x = np.random.default_rng(0).normal(0, 1, (2, 50)).astype(np.float32)
    got = tf.pre_emphasis(t(x)).numpy()
    close(got, jf.pre_emphasis(jnp.asarray(x)), 1e-6, "pre_emphasis")
    np.testing.assert_allclose(got[:, 0], x[:, 0] - 0.97 * x[:, 1], rtol=1e-6)


def _crops_of_unequal_loudness(seed: int) -> np.ndarray:
    """``[B, crops, T]`` waves whose crops differ in level by up to 10^5,
    so that a ``top_db`` clamp against the utterance's maximum (not each
    crop's) would floor the quiet crops."""
    x = np.random.default_rng(seed).normal(0, 1, (2, 3, 4000))
    x *= np.array([[1.0, 1e-3, 30.0], [1e-2, 1.0, 1e-4]])[:, :, None]
    return x.astype(np.float32)


@pytest.mark.parametrize("feature_type", ["mfcc", "spectrogram"])
def test_mfcc_and_spectrogram_match_jax(feature_type):
    """Each band-edge default of ``from_hparams`` (mfcc: 10/4000 Hz) and
    ``[B, crops, T]`` input. Tolerance 1e-5 of the largest value for each
    crop (the spectrogram's crops differ by 10^10 in power)."""
    h = {"sample_rate": 16000, "n_mfcc": 40, "n_mels": 64}
    jcfg = jf.FrontendConfig.from_hparams(h, feature_type)
    tcfg = tf.FrontendConfig.from_hparams(h, feature_type)
    x = _crops_of_unequal_loudness(seed=1)
    ref = np.asarray(jf.make_frontend(jcfg, feature_type)(jnp.asarray(x)))
    got = tf.make_frontend(tcfg, feature_type)(t(x)).numpy()
    width = 40 if feature_type == "mfcc" else 257
    assert got.shape == ref.shape == (2, 3, 26, width)
    for b in range(2):
        for c in range(3):
            close(got[b, c], ref[b, c], REL, f"{feature_type} [{b}, {c}]")
    # the mel kernel stays melspectrogram-only, as JAX dispatches it
    assert tf.select_mel_frontend(tcfg, feature_type, "pallas", t(x)) \
        .__qualname__.startswith("make_frontend")


def test_mfcc_top_db_clamps_each_crop():
    """``top_db`` clamps each row of the flattened ``[-1, T]`` waves: a
    quiet crop keeps its own 80 dB range, whatever its utterance holds."""
    cfg = tf.FrontendConfig.from_hparams({"sample_rate": 16000}, "mfcc")
    x = t(_crops_of_unequal_loudness(seed=2))
    fb = torch.as_tensor(tf.mel_filterbank(257, 80, 16000, 10.0, 4000.0))
    mel = tf.make_frontend(cfg, "spectrogram")(x) @ fb   # [2, 3, F, 80]
    per_crop = tf.power_to_db(mel.reshape(6, 26, 80))
    per_utt = tf.power_to_db(mel.reshape(2, 78, 80)).reshape(6, 26, 80)
    span = per_crop.amax(dim=(1, 2)) - per_crop.amin(dim=(1, 2))
    assert float(span.max()) <= 80.0 + 1e-4
    assert not torch.allclose(per_crop, per_utt)      # the quiet crops
    np.testing.assert_allclose(
        per_crop.numpy(), np.asarray(jf.power_to_db(jnp.asarray(
            mel.reshape(6, 26, 80).numpy()))), rtol=0, atol=1e-4)
    got = tf.make_frontend(cfg, "mfcc")(x).reshape(6, 26, 80)
    torch.testing.assert_close(
        got, per_crop @ torch.as_tensor(tf.dct_matrix(80, 80)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("norm", ["ortho", None])
def test_dct_matrix_matches_jax(norm):
    np.testing.assert_array_equal(tf.dct_matrix(40, 64, norm),
                                  jf.dct_matrix(40, 64, norm))


def test_raw_is_passthrough_and_backend_choice():
    x = torch.ones(2, 10)
    assert tf.make_frontend(tf.FrontendConfig(), "raw")(x) is x
    assert not tf.use_kernel("auto", x)
    assert tf.use_kernel("pallas", x) and not tf.use_kernel("xla", x)
    with pytest.raises(ValueError):
        tf.use_kernel("cudnn", x)
