"""The port's ``ops/signal.py`` against the JAX package's.

Inputs are made with numpy from a seed and handed to both. Tolerances:
fp32, 1e-5 absolute on unit-scale data (1e-4 on dB values, which are
tens of units); ``convolve1d``'s FFT branch and ``reverberate`` within
1e-4 of the output's largest magnitude (two FFT libraries, fp32 sums of
T terms in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.ops import signal as js
from speakerverification_tpu_torch.ops import signal as ts

ATOL = 1e-5
FFT_REL = 1e-4


def _np(x):
    return np.asarray(x)


def _waves(seed, shape=(3, 400), scale=0.3):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


@pytest.mark.parametrize("amp_type", ["avg", "peak"])
@pytest.mark.parametrize("scale", ["linear", "dB"])
def test_amplitude_normalize_rescale(amp_type, scale):
    x = _waves(0)
    np.testing.assert_allclose(
        ts.compute_amplitude(torch.from_numpy(x), amp_type=amp_type,
                             scale=scale).numpy(),
        _np(js.compute_amplitude(jnp.asarray(x), amp_type=amp_type,
                                 scale=scale)), atol=1e-4 if scale == "dB"
        else ATOL, rtol=1e-6)
    np.testing.assert_allclose(
        ts.normalize_amplitude(torch.from_numpy(x), amp_type).numpy(),
        _np(js.normalize_amplitude(jnp.asarray(x), amp_type)), atol=ATOL)
    lvl = -12.0 if scale == "dB" else 0.5
    np.testing.assert_allclose(
        ts.rescale(torch.from_numpy(x), lvl, amp_type, scale).numpy(),
        _np(js.rescale(jnp.asarray(x), lvl, amp_type, scale)), atol=ATOL)


def test_amplitude_with_lengths():
    x = _waves(1)
    lengths = np.asarray([400.0, 300.0, 200.0], np.float32)
    np.testing.assert_allclose(
        ts.compute_amplitude(torch.from_numpy(x),
                             torch.from_numpy(lengths)).numpy(),
        _np(js.compute_amplitude(jnp.asarray(x), jnp.asarray(lengths))),
        atol=ATOL)


def test_db_conversions():
    db = np.linspace(-60, 10, 50).astype(np.float32)
    amp = ts.db_to_amplitude(torch.from_numpy(db))
    np.testing.assert_allclose(amp.numpy(),
                               _np(js.db_to_amplitude(jnp.asarray(db))),
                               rtol=1e-5)
    back = ts.amplitude_to_db(amp)
    np.testing.assert_allclose(
        back.numpy(), _np(js.amplitude_to_db(jnp.asarray(amp.numpy()))),
        atol=1e-4)
    np.testing.assert_allclose(back.numpy(), db, atol=1e-3)
    x = np.asarray([0.0, -1e-20, 0.5], np.float32)
    np.testing.assert_allclose(ts.amplitude_to_db(torch.from_numpy(x)),
                               _np(js.amplitude_to_db(jnp.asarray(x))))


# an asymmetric kernel (the two branches disagree on it), shared and per
# row, with and without padding; the FFT branch's rotation as an int, as
# one traced value and per row
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("padding", [0, 7, (3, 11)])
def test_convolve1d_direct_branch(per_row, padding):
    x = _waves(2, (3, 300))
    rng = np.random.default_rng(3)
    k = rng.normal(size=(3, 21) if per_row else (21,)).astype(np.float32)
    got = ts.convolve1d(torch.from_numpy(x), torch.from_numpy(k), padding,
                        use_fft=False).numpy()
    ref = _np(js.convolve1d(jnp.asarray(x), jnp.asarray(k), padding,
                            use_fft=False))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("rotation", [0, 9, "scalar", "per_row"])
@pytest.mark.parametrize("per_row", [False, True])
def test_convolve1d_fft_branch(rotation, per_row):
    x = _waves(4, (3, 300))
    rng = np.random.default_rng(5)
    k = rng.normal(size=(3, 40) if per_row else (40,)).astype(np.float32)
    rot_np = {"scalar": np.asarray(13), "per_row": np.asarray([0, 5, 299])}
    if rotation in rot_np:
        rt, rj = torch.from_numpy(rot_np[rotation]), jnp.asarray(
            rot_np[rotation])
    else:
        rt = rj = rotation
    got = ts.convolve1d(torch.from_numpy(x), torch.from_numpy(k), 4,
                        use_fft=True, rotation_index=rt).numpy()
    ref = _np(js.convolve1d(jnp.asarray(x), jnp.asarray(k), 4, use_fft=True,
                            rotation_index=rj))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=FFT_REL * np.abs(ref).max())


def test_convolve1d_fft_kernel_longer_than_signal():
    x = _waves(6, (2, 50))
    k = np.random.default_rng(7).normal(size=(80,)).astype(np.float32)
    got = ts.convolve1d(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    ref = _np(js.convolve1d(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, ref, atol=FFT_REL * np.abs(ref).max())


@pytest.mark.parametrize("rescale_amp", ["avg", "peak"])
@pytest.mark.parametrize("per_row", [False, True])
def test_reverberate(rescale_amp, per_row):
    x = _waves(8, (3, 1600))
    rng = np.random.default_rng(9)
    n = 500
    decay = np.exp(-np.arange(n) / 80.0)
    rir = (rng.normal(size=(3, n) if per_row else (n,)) * decay).astype(
        np.float32)
    got = ts.reverberate(torch.from_numpy(x), torch.from_numpy(rir),
                         rescale_amp).numpy()
    ref = _np(js.reverberate(jnp.asarray(x), jnp.asarray(rir), rescale_amp))
    np.testing.assert_allclose(got, ref, atol=FFT_REL * np.abs(ref).max())


@pytest.mark.parametrize("freq,width", [(0.25, 101), (0.1, 51), (0.4, 33)])
def test_notch_filter(freq, width):
    np.testing.assert_allclose(ts.notch_filter(freq, width).numpy(),
                               _np(js.notch_filter(freq, width)), atol=ATOL)


@pytest.mark.parametrize("shape,step", [((8, 5), 5), ((2, 3, 7, 16), 4),
                                        ((1, 1, 9), 3)])
def test_overlap_and_add(shape, step):
    fr = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    got = ts.overlap_and_add(torch.from_numpy(fr), step).numpy()
    ref = _np(js.overlap_and_add(jnp.asarray(fr), step))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_gabor_impulse_response():
    t = np.arange(-20, 21, dtype=np.float32)
    rng = np.random.default_rng(11)
    center = rng.uniform(0.1, 3.0, 6).astype(np.float32)
    fwhm = rng.uniform(1.0, 8.0, 6).astype(np.float32)
    got = ts.gabor_impulse_response(torch.from_numpy(t),
                                    torch.from_numpy(center),
                                    torch.from_numpy(fwhm))
    ref = _np(js.gabor_impulse_response(jnp.asarray(t), jnp.asarray(center),
                                        jnp.asarray(fwhm)))
    assert got.dtype == torch.complex64 and ref.dtype == np.complex64
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
