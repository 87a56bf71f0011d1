"""On-device augmentation, port against the JAX package (CPU), with JAX's
draws replayed into the port's apply functions.

* ``build_banks``: the same generator gives the same banks, bit for bit
  (host numpy in both), and ``banks_from_arrays`` carries the JAX
  package's banks across.
* ``_mix_noise``, ``_reverberate`` (the port pads its FFT to a power of
  two, JAX to L + Lr − 1), ``device_env_corrupt`` and ``time_augment``
  in both modes, with banks and without, 2-D and 3-D: to 2e-5 of the
  output's largest magnitude (float32 FFTs of different lengths and
  libraries; 4e-6 measured).
* The port's own draws: env types at .2/.4/.2/.2 within 4σ over 65,536
  rows, exactly k ∈ [4, 10] members per row in ``np`` mode, each k
  about equally often, and the ``torch`` mode's gates at their rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.data.augment import AugmentWav as JAugmentWav
from speakerverification_tpu.ops import device_augment as jda
from speakerverification_tpu.ops import timeaugment as jta
from speakerverification_tpu_torch.data.augment import (
    AugmentWav as TAugmentWav,
)
from speakerverification_tpu_torch.ops import device_augment as tda
from speakerverification_tpu_torch.ops import timeaugment as tta

from test_torch_port_augment_helpers import (
    SPEC,
    SR,
    env_draw,
    time_draw_np,
    time_draw_torch,
    write_noise_corpus,
)

TOL = 2e-5


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """The JAX package's banks and the port's, each built by its own
    ``build_banks`` from the same generator seed."""
    opts = write_noise_corpus(tmp_path_factory.mktemp("bank_corpus"))
    jbanks = jda.build_banks(JAugmentWav(opts, SPEC), n_noise=12, n_rir=5,
                             rng=np.random.default_rng(3))
    tbanks = tda.build_banks(TAugmentWav(opts, SPEC), n_noise=12, n_rir=5,
                             rng=np.random.default_rng(3), device="cpu")
    return jbanks, tbanks


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), f"{what}: {err:.3e}"


def waves(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).normal(0, 1, shape)).astype(
        np.float32)


def test_build_banks_is_byte_identical(banks):
    jbanks, tbanks = banks
    for name in tda.AugmentBanks._fields:
        got = getattr(tbanks, name).numpy()
        want = np.asarray(getattr(jbanks, name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tbanks.noise.shape == (12, 4000) and tbanks.rir.shape == (5, 4000)
    # RIRs longer than the crop are cut, shorter ones zero-padded
    np.testing.assert_allclose((tbanks.rir ** 2).sum(1).numpy(), 1.0,
                               atol=1e-2)


def test_banks_from_arrays_carries_the_jax_banks(banks):
    jbanks, tbanks = banks
    carried = tda.banks_from_arrays(jbanks, device="cpu")
    for a, b in zip(carried, tbanks):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mix_and_reverberate_match_jax(banks):
    jbanks, tbanks = banks
    x = waves((5, 4000), 1)
    snr = np.linspace(0, 15, 5).astype(np.float32)
    close(tda._mix_noise(torch.from_numpy(x), tbanks.noise[:5],
                         tbanks.noise_db[:5], torch.from_numpy(snr)),
          jda._mix_noise(jnp.asarray(x), jbanks.noise[:5],
                         jbanks.noise_db[:5], jnp.asarray(snr)), "mix")
    close(tda._reverberate(torch.from_numpy(x), tbanks.rir),
          jda._reverberate(jnp.asarray(x), jbanks.rir), "reverberate")
    # a short RIR: the same first L samples at any FFT length ≥ L + Lr − 1
    r = waves((5, 300), 2)
    close(tda._reverberate(torch.from_numpy(x), torch.from_numpy(r)),
          jda._reverberate(jnp.asarray(x), jnp.asarray(r)), "short RIR")


@pytest.mark.parametrize("shape", [(16, 4000), (8, 2, 4000)],
                         ids=["2-D", "3-D"])
def test_device_env_corrupt_matches_jax(banks, shape):
    jbanks, tbanks = banks
    x = waves(shape, 3)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jda.device_env_corrupt(jnp.asarray(x), jbanks, key)
        draw = env_draw(key, 16, jbanks)
        got = tda.apply_env_corrupt(torch.from_numpy(x), draw, tbanks)
        close(got.numpy(), want, f"seed {seed}")
        kinds = set(draw.augtype.tolist())
    assert kinds >= {0, 1}


@pytest.mark.parametrize("with_banks", [True, False], ids=["banks", "none"])
@pytest.mark.parametrize("mode", ["np", "torch"])
def test_time_augment_matches_jax(banks, mode, with_banks):
    jbanks, tbanks = banks if with_banks else (None, None)
    x = waves((12, 4000), 4)
    x[0] *= 8.0                                  # peak normalization
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = jta.time_augment(jnp.asarray(x), key, jbanks, mode=mode,
                                sample_rate=SR)
        draw = (time_draw_np(key, 12, 4000, jbanks, SR) if mode == "np"
                else time_draw_torch(key, 12, 4000, jbanks))
        got = tta.apply_time_augment(torch.from_numpy(x), draw, tbanks,
                                     sample_rate=SR)
        close(got.numpy(), want, f"{mode} seed {seed}")


def test_time_augment_3d_input(banks):
    jbanks, tbanks = banks
    x = waves((4, 3, 4000), 5)
    key = jax.random.PRNGKey(9)
    want = jta.time_augment(jnp.asarray(x), key, jbanks, mode="np",
                            sample_rate=SR)
    got = tta.apply_time_augment(torch.from_numpy(x),
                                 time_draw_np(key, 12, 4000, jbanks, SR),
                                 tbanks, sample_rate=SR)
    assert got.shape == (4, 3, 4000)
    close(got.numpy(), want, "3-D")
    out = tta.time_augment(torch.from_numpy(x),
                           torch.Generator().manual_seed(0), tbanks)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_env_types_are_drawn_at_their_rates(banks):
    _, tbanks = banks
    n = 65536
    draw = tda.draw_env_corrupt(torch.Generator().manual_seed(0), n, tbanks)
    share = torch.bincount(draw.augtype, minlength=4).double() / n
    p = torch.tensor([0.2, 0.4, 0.2, 0.2], dtype=torch.float64)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert ((share - p).abs() <= 4 * sigma).all(), share
    assert 0.48 < float(draw.rev_first.double().mean()) < 0.52
    lo, hi = tbanks.snr_lo[draw.noise_idx], tbanks.snr_hi[draw.noise_idx]
    assert bool(((draw.snr >= lo) & (draw.snr <= hi)).all())
    # the 'none' rows come out untouched
    x = torch.from_numpy(waves((64, 4000), 6))
    small = tda.draw_env_corrupt(torch.Generator().manual_seed(1), 64,
                                 tbanks)
    out = tda.apply_env_corrupt(x, small, tbanks)
    same = (out == x).all(dim=1)
    assert torch.equal(same, small.augtype == 3)


def test_np_mode_runs_exactly_k_members(banks):
    _, tbanks = banks
    n = 20000
    d = tta.draw_time_augment(torch.Generator().manual_seed(2), n, 64,
                              tbanks, mode="np", sample_rate=SR)
    k = d.sel.sum(dim=1)
    assert int(k.min()) == 4 and int(k.max()) == 10
    counts = torch.bincount(k, minlength=11)[4:].double() / n
    assert (counts - 1 / 7).abs().max() < 0.02, counts
    per_member = d.sel.double().mean(dim=0)
    assert (per_member - 7 / 10).abs().max() < 0.02, per_member


def test_torch_mode_gates_fire_at_their_rates(banks):
    _, tbanks = banks
    n = 20000
    d = tta.draw_time_augment(torch.Generator().manual_seed(3), n, 64,
                              tbanks, mode="torch", polarity_p=0.3)
    for gate, p in ((d.gain_on, 0.5), (d.shift_on, 0.25),
                    (d.polarity_on, 0.3), (d.noise_on, 0.5),
                    (d.bg_on, 0.5), (d.rir_on, 0.25)):
        assert abs(float(gate.double().mean()) - p) < 0.015
    assert int(d.shift.abs().max()) <= 16 and d.white.shape == (n, 64)
    none = tta.draw_time_augment(torch.Generator().manual_seed(3), 4, 64,
                                 None, mode="torch")
    assert none.bg_idx is None and none.rir_idx is None
    with pytest.raises(ValueError, match="mode"):
        tta.draw_time_augment(torch.Generator(), 4, 64, None, mode="x")
