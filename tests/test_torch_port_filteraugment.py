"""The port's ``ops/filteraugment.py`` against the JAX package's.

jax.random's stream cannot be reproduced in torch, so each op is held in
two parts:

* its deterministic core, fed JAX's own draws: the test splits JAX's key
  as the JAX op does, draws with ``jax.random`` and hands the values to
  the port's core, which must give the JAX op's output within 1e-6;
* its draws, held to their distributions over >= 10,000 draws
  (``frame_shift``'s shift std ~ sigma and ``mixup``'s coefficient mean
  ~ alpha / (alpha + beta), each within 5 %; mask widths and starts in
  their ranges), and the same generator seed giving the same output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.ops import filteraugment as JFA
from speakerverification_tpu_torch.ops import filteraugment as TFA

ATOL = 1e-6
KEYS = [0, 1, 2, 3, 7]


def _x(seed=6, shape=(4, 50, 32)):
    return np.random.default_rng(seed).normal(2.0, 1.0, shape).astype(
        np.float32)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", KEYS)
def test_frame_shift_core(seed):
    x, key = _x(), jax.random.PRNGKey(seed)
    shifts = (jax.random.normal(key, (x.shape[0],)) * 90.0).astype(jnp.int32)
    _close(TFA.frame_shift_apply(torch.from_numpy(x),
                                 torch.from_numpy(np.array(shifts))),
           JFA.frame_shift(key, jnp.asarray(x)))


@pytest.mark.parametrize("label_type", ["soft", "hard"])
@pytest.mark.parametrize("seed", KEYS)
def test_mixup_core(seed, label_type):
    x, key = _x(), jax.random.PRNGKey(seed)
    label = np.random.default_rng(seed).uniform(0, 1, (4, 10)).astype(
        np.float32)
    k_perm, k_c = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, x.shape[0]))
    c = float(jax.random.beta(k_c, 0.2, 0.2))
    if label_type == "hard":
        c = c * 0.4 + 0.3
    ref_x, ref_l = JFA.mixup(key, jnp.asarray(x), jnp.asarray(label),
                             mixup_label_type=label_type)
    got_x, got_l = TFA.mixup_apply(torch.from_numpy(x), torch.from_numpy(perm),
                                   c, torch.from_numpy(label), label_type)
    _close(got_x, ref_x)
    _close(got_l, ref_l)


@pytest.mark.parametrize("ratios", [(10, 20), (5, 8)])
@pytest.mark.parametrize("seed", KEYS)
def test_time_mask_core(seed, ratios):
    x, key = _x(), jax.random.PRNGKey(seed)
    T = x.shape[1]
    k_w, k_p = jax.random.split(key)
    lo, hi = T // ratios[1], T // ratios[0]
    width = int(jax.random.randint(k_w, (), lo, max(hi, lo + 1)))
    start = int(jax.random.randint(k_p, (), 0, max(T - width, 1)))
    _close(TFA.time_mask_apply(torch.from_numpy(x), width, start),
           JFA.time_mask(key, jnp.asarray(x), ratios))


def _filt_draws(key, B, F, n_band, min_bw, filter_type, db_range):
    k_n, k_bound, k_gain = jax.random.split(key, 3)
    n_max = max(n_band[1] - 1, 2)
    n = int(jax.random.randint(k_n, (), n_band[0], n_band[1]))
    bw = min(min_bw, (F + 1) // max(n, 1))
    raw = np.asarray(jax.random.randint(k_bound, (n_max - 1,), 0,
                                        max(F - n * bw + 1, 1)))
    cols = n_max if filter_type == "step" else n_max + 1
    g_db = np.asarray(jax.random.uniform(k_gain, (B, cols),
                                         minval=db_range[0],
                                         maxval=db_range[1]))
    return n, torch.from_numpy(raw), torch.from_numpy(g_db)


@pytest.mark.parametrize("filter_type,n_band,min_bw", [
    ("linear", (3, 6), 6), ("step", (2, 5), 4), ("linear", (1, 4), 6),
    ("step", (3, 9), 12)])
@pytest.mark.parametrize("seed", KEYS)
def test_filt_aug_core(seed, filter_type, n_band, min_bw):
    x, key = _x(), jax.random.PRNGKey(seed)
    n, raw, g_db = _filt_draws(key, x.shape[0], x.shape[2], n_band, min_bw,
                               filter_type, (-6.0, 6.0))
    ref = JFA.filt_aug(key, jnp.asarray(x), n_band=n_band, min_bw=min_bw,
                       filter_type=filter_type)
    _close(TFA.filt_aug_apply(torch.from_numpy(x), n, raw, g_db, min_bw,
                              filter_type), ref)


@pytest.mark.parametrize("n_bands", [(2, 5), (1, 3)])
@pytest.mark.parametrize("seed", KEYS)
def test_filt_aug_prototype_core(seed, n_bands):
    x, key = _x(), jax.random.PRNGKey(seed)
    B, _, F = x.shape
    k_n, k_bound, k_gain = jax.random.split(key, 3)
    n_max = max(n_bands[1] - 1, 2)
    n = int(jax.random.randint(k_n, (), n_bands[0], n_bands[1]))
    raw = np.asarray(jax.random.randint(k_bound, (n_max - 1,), 1,
                                        max(F - 1, 2)))
    g_db = np.asarray(jax.random.uniform(k_gain, (B, n_max), minval=-7.5,
                                         maxval=6.0))
    _close(TFA.filt_aug_prototype_apply(torch.from_numpy(x), n,
                                        torch.from_numpy(raw),
                                        torch.from_numpy(g_db)),
           JFA.filt_aug_prototype(key, jnp.asarray(x), n_bands=n_bands))


@pytest.mark.parametrize("ratio", [16, 8, 40])
@pytest.mark.parametrize("seed", KEYS)
def test_freq_mask_core(seed, ratio):
    x, key = _x(), jax.random.PRNGKey(seed)
    B, _, F = x.shape
    k_w, k_p = jax.random.split(key)
    max_mask = int(F / ratio)
    widths = (jnp.ones((B,), jnp.int32) if max_mask <= 1
              else jax.random.randint(k_w, (B,), 1, max_mask))
    starts = jax.random.randint(k_p, (B,), 0, jnp.maximum(F - widths, 1))
    _close(TFA.freq_mask_apply(torch.from_numpy(x),
                               torch.from_numpy(np.asarray(widths)),
                               torch.from_numpy(np.asarray(starts))),
           JFA.freq_mask(key, jnp.asarray(x), ratio))


@pytest.mark.parametrize("snrs", [(15.0, 30.0), 20.0])
@pytest.mark.parametrize("seed", KEYS)
def test_add_noise_core(seed, snrs):
    x, key = _x(), jax.random.PRNGKey(seed)
    k_snr, k_noise = jax.random.split(key)
    if isinstance(snrs, tuple):
        u = jax.random.uniform(k_snr, (x.shape[0], 1, 1))
        snr = torch.from_numpy(np.asarray((snrs[0] - snrs[1]) * u + snrs[1]))
    else:
        snr = snrs
    noise = torch.from_numpy(np.asarray(
        jax.random.normal(k_noise, x.shape, jnp.float32)))
    _close(TFA.add_noise_apply(torch.from_numpy(x), snr, noise),
           JFA.add_noise(key, jnp.asarray(x), snrs=snrs))


# ----------------------------------------------------------------------
# the draws
# ----------------------------------------------------------------------
def test_frame_shift_draws_have_std_sigma():
    B, T, sigma = 10_000, 1024, 90.0
    x = torch.arange(T, dtype=torch.float32).expand(B, T)[..., None]
    y = TFA.frame_shift(torch.Generator().manual_seed(0), x, sigma)
    shifts = (y[:, 0, 0] * -1) % T                 # y[:, 0] = x[-shift]
    shifts = torch.where(shifts >= T // 2, shifts - T, shifts)
    assert abs(shifts.float().std().item() / sigma - 1) < 0.05
    assert abs(shifts.float().mean().item()) < 0.05 * sigma


@pytest.mark.parametrize("alpha,beta", [(0.2, 0.2), (2.0, 5.0), (0.5, 3.0)])
def test_mixup_coefficient_mean(alpha, beta):
    c = TFA.draw_beta(torch.Generator().manual_seed(1), alpha, beta, 10_000)
    assert bool(((c >= 0) & (c <= 1)).all())
    assert abs(c.mean().item() / (alpha / (alpha + beta)) - 1) < 0.05
    # mixup itself draws its coefficient there
    x = torch.ones(3, 4, 5)
    y = TFA.mixup(torch.Generator().manual_seed(2), x)
    assert torch.allclose(y, x)


def test_time_mask_draws_in_range():
    T = 200
    x = torch.ones(1, T, 3)
    gen = torch.Generator().manual_seed(3)
    widths, starts = [], []
    for _ in range(500):
        rows = (TFA.time_mask(gen, x)[0, :, 0] == 0).nonzero()[:, 0]
        widths.append(len(rows))
        starts.append(int(rows[0]))
        assert int(rows[-1]) - int(rows[0]) + 1 == len(rows)
    assert min(widths) >= T // 20 and max(widths) < T // 10
    assert min(starts) >= 0
    assert all(s < T - w for s, w in zip(starts, widths))


def test_freq_mask_draws_in_range():
    B, F, ratio = 10_000, 80, 16
    y = TFA.freq_mask(torch.Generator().manual_seed(4), torch.ones(B, 1, F),
                      ratio)
    zero = y[:, 0, :] == 0
    widths = zero.sum(-1)
    starts = zero.float().argmax(-1)
    assert int(widths.min()) >= 1 and int(widths.max()) < F // ratio
    assert set(widths.tolist()) == set(range(1, F // ratio))
    assert bool((starts < F - widths).all())
    assert int(starts.max()) > F - F // ratio - 2


def test_filt_aug_draws_in_range():
    x = torch.ones(2, 3, 40)
    gen = torch.Generator().manual_seed(5)
    for filter_type in ("linear", "step", 0.5):
        for _ in range(50):
            y = TFA.filt_aug(gen, x, filter_type=filter_type)
            db = 20 * torch.log10(y)
            assert bool(torch.isfinite(y).all())
            assert float(db.abs().max()) <= 6.0 + 1e-4
    y = TFA.filt_aug_prototype(gen, x)
    assert float((20 * torch.log10(y)).min()) >= -7.5 - 1e-4


OPS = {
    "frame_shift": lambda g, x: TFA.frame_shift(g, x),
    "mixup": lambda g, x: TFA.mixup(g, x),
    "time_mask": lambda g, x: TFA.time_mask(g, x),
    "filt_aug": lambda g, x: TFA.filt_aug(g, x),
    "filt_aug_mixed": lambda g, x: TFA.filt_aug(g, x, filter_type=0.5),
    "filt_aug_prototype": lambda g, x: TFA.filt_aug_prototype(g, x),
    "freq_mask": lambda g, x: TFA.freq_mask(g, x),
    "add_noise": lambda g, x: TFA.add_noise(g, x),
    "feature_transformation": lambda g, x: torch.stack(
        TFA.feature_transformation(g, x, 2, (True, True, True))),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_same_seed_same_output(name):
    x = torch.from_numpy(_x())
    a = OPS[name](torch.Generator().manual_seed(11), x)
    b = OPS[name](torch.Generator().manual_seed(11), x)
    c = OPS[name](torch.Generator().manual_seed(12), x)
    assert a.shape[-3:] == x.shape and torch.equal(a, b)
    assert not torch.equal(a, c)


def test_feature_transformation_views():
    x = torch.from_numpy(_x())
    gen = torch.Generator().manual_seed(13)
    a, b = TFA.feature_transformation(gen, x, 2, (True, True, True))
    assert a.shape == b.shape == x.shape and not torch.equal(a, b)
    a, b = TFA.feature_transformation(gen, x, 1, (True, False, True),
                                      filtaug_choice="prototype")
    assert a is b and not torch.equal(a, x)
    a, b = TFA.feature_transformation(gen, x, 0, (True, True, True))
    assert a is x and b is x
