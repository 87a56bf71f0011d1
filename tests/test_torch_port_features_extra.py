"""The port's ``ops/features_extra.py`` against the JAX package's.

Inputs are made with numpy from a seed. Tolerances:
``speechbrain_fbank_matrix`` bit for bit (both are the same float32
numpy); the rest within 1e-5 absolute on unit-scale features (1e-4 on
dB values, tens of units); ``istft(stft(x))`` reconstructs the interior
as JAX's own test asks (5 % of the peak).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.ops import features_extra as jfx
from speakerverification_tpu.ops import frontend as jf
from speakerverification_tpu_torch.ops import features_extra as tfx
from speakerverification_tpu_torch.ops import frontend as tf

ATOL = 1e-5


def _feats(seed, shape=(3, 37, 12)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("window_length", [3, 5, 9])
def test_deltas(window_length):
    x = _feats(0)
    got = tfx.deltas(torch.from_numpy(x), window_length).numpy()
    ref = np.asarray(jfx.deltas(jnp.asarray(x), window_length))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_deltas_of_a_ramp_are_its_slope():
    t = np.arange(50, dtype=np.float32)
    x = torch.from_numpy(np.stack([2.0 * t, -1.0 * t], -1)[None])
    d = tfx.deltas(x, 5).numpy()
    np.testing.assert_allclose(d[0, 10:40, 0], 2.0, rtol=1e-4)
    np.testing.assert_allclose(d[0, 10:40, 1], -1.0, rtol=1e-4)


@pytest.mark.parametrize("left,right", [(5, 5), (1, 1), (0, 3), (2, 0)])
def test_context_window(left, right):
    x = _feats(1, (2, 9, 4))
    got = tfx.context_window(torch.from_numpy(x), left, right).numpy()
    ref = np.asarray(jfx.context_window(jnp.asarray(x), left, right))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _stft(x, cfg):
    cos_b, sin_b = jf.dft_matrices(cfg.n_fft, cfg.win_length, cfg.window)
    pad = cfg.n_fft // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    frames = xp[:, jf.frame_indices(xp.shape[-1], cfg.n_fft, cfg.hop_length)]
    return ((frames @ cos_b).astype(np.float32),
            (frames @ sin_b).astype(np.float32))


@pytest.mark.parametrize("length", [8000, None])
def test_istft_matches_jax_and_round_trips(length):
    jcfg = jf.FrontendConfig(pre_emphasis=None)
    tcfg = tf.FrontendConfig(pre_emphasis=None)
    x = np.random.default_rng(3).normal(0, 0.3, (2, 8000)).astype(np.float32)
    real, imag = _stft(x, jcfg)
    got = tfx.istft(torch.from_numpy(real), torch.from_numpy(imag), tcfg,
                    length=length).numpy()
    ref = np.asarray(jfx.istft(jnp.asarray(real), jnp.asarray(imag), jcfg,
                               length=length))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # JAX's own round-trip check: the interior comes back
    sl = slice(jcfg.n_fft, 8000 - jcfg.n_fft)
    err = np.abs(got[0, sl] - x[0, sl]).max() / np.abs(x).max()
    assert err < 0.05


# the three filter shapes, and an odd sample rate (integer halving)
@pytest.mark.parametrize("shape", ["triangular", "rectangular", "gaussian"])
@pytest.mark.parametrize("kw", [
    dict(), dict(n_mels=80, f_max=4000.0, n_fft=512, sample_rate=8000),
    dict(n_mels=24, f_min=20.0, f_max=11025.0, n_fft=441,
         sample_rate=22051)])
def test_speechbrain_fbank_matrix_bit_for_bit(shape, kw):
    got = tfx.speechbrain_fbank_matrix(filter_shape=shape, **kw)
    ref = jfx.speechbrain_fbank_matrix(filter_shape=shape, **kw)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_speechbrain_fbank_matrix_rejects_unknown_shape():
    with pytest.raises(ValueError, match="filter_shape"):
        tfx.speechbrain_fbank_matrix(filter_shape="cosine")


@pytest.mark.parametrize("power", [2, 1])
def test_speechbrain_log_fbank(power):
    rng = np.random.default_rng(4)
    # per-sequence dynamic range: the second sequence 60 dB quieter, so a
    # per-batch floor would clip it
    fb = rng.uniform(0, 1, (2, 30, 16)).astype(np.float32) ** 8
    fb[1] *= 1e-6
    got = tfx.speechbrain_log_fbank(torch.from_numpy(fb), power).numpy()
    ref = np.asarray(jfx.speechbrain_log_fbank(jnp.asarray(fb), power))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert got[1].max() < got[0].max() - 50
