"""SpecAugment, port against the JAX package (CPU), with JAX's draws
replayed (the same ``jax.random`` calls on the same split keys, handed
to the port's ``apply_spec_augment``).

* ``ops/specaugment.py`` alone: zero fill, mean fill (recomputed per
  stage), and the warp's edges on 12-frame inputs (a 1-frame segment,
  pivots at both ends); to 1e-6 of the largest feature (the masks are
  exact; the warp's cubic weights are float32 polynomials), and to 4e-6
  with the mean fill (the two packages sum the mean in other orders:
  1.8e-6 measured).
* Through a small ``RawECAPAHybrid`` (the same class as ``Raw3_ECAPA``'s)
  in training mode: the ECAPA half of the embedding (train-mode
  BatchNorm) to 1e-4; in eval SpecAugment is off.
* Through ``SpeakerEncoder`` around ECAPA_TDNN (mel features) to 1e-4.
* The builder turns it on for ``augment`` with ``spec_domain`` only,
  and ``Raw3_ECAPA``'s forward feeds its ECAPA branch the augmented
  features in training and the plain ones in eval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import encoder as jencoder
from speakerverification_tpu.models import hybrids as jhybrids
from speakerverification_tpu.encoder import SpeakerEncoder as JEncoder
from speakerverification_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA
from speakerverification_tpu.models.hybrids import RawECAPAHybrid as JHybrid
from speakerverification_tpu.models.rawnet3 import RawNet3 as JRawNet3
from speakerverification_tpu.ops import specaugment as jsa
from speakerverification_tpu.ops.frontend import FrontendConfig as JCfg
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.encoder import SpeakerEncoder as TEncoder
from speakerverification_tpu_torch.models import hybrids as thybrids
from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN as TECAPA
from speakerverification_tpu_torch.models.rawnet3 import RawNet3 as TRawNet3
from speakerverification_tpu_torch.ops import specaugment as tsa
from speakerverification_tpu_torch.ops.frontend import FrontendConfig as TCfg

from test_torch_port_augment_helpers import spec_draw
from test_torch_port_helpers import close, init_pair, t

ECAPA_SMALL = dict(lin_neurons=16, channels=(32, 32, 32, 32, 96),
                   attention_channels=8, se_channels=8, res2net_scale=4)


def configs(**kw):
    return jsa.SpecAugmentConfig(**kw), tsa.SpecAugmentConfig(**kw)


def keys_used(monkeypatch, module) -> list:
    """The keys a flax module hands ``spec_augment`` (its ``make_rng``
    folds the module's path into the apply's key), recorded as it runs."""
    keys = []

    def recording(key, x, cfg):
        keys.append(key)
        return jsa.spec_augment(key, x, cfg)
    monkeypatch.setattr(module, "spec_augment", recording)
    return keys


def _feats(shape, seed):
    return np.abs(np.random.default_rng(seed).normal(1.0, 1.0, shape)
                  ).astype(np.float32)


@pytest.mark.parametrize("kw,tol", [
    ({}, 1e-6), ({"replace_with_zero": False}, 4e-6),
    ({"time_warp": False, "n_time_mask": 3}, 1e-6),
    ({"freq_mask_width": (4, 9), "time_mask_width": (2, 3)}, 1e-6)],
    ids=["zero fill", "mean fill", "masks only", "widths"])
def test_spec_augment_matches_jax(kw, tol):
    jcfg, tcfg = configs(**kw)
    x = _feats((4, 51, 20), 0)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsa.spec_augment(key, jnp.asarray(x), jcfg))
        got = tsa.apply_spec_augment(t(x), spec_draw(key, x.shape, tcfg),
                                     tcfg).numpy()
        close(got, want, tol, f"seed {seed}")
        if kw.get("replace_with_zero", True):
            assert (got == 0).any()


def test_warp_edges_match_jax():
    """12 frames, window 5: pivots 5 and 6, targets 1 … 11 (a one-frame
    left or right segment); 10 frames: no warp at all."""
    jcfg, tcfg = configs(freq_mask=False, time_mask=False)
    x = _feats((2, 12, 6), 1)
    seen = set()
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        draw = spec_draw(key, x.shape, tcfg)
        seen.add((int(draw.warp[0]), int(draw.warp[1])))
        want = np.asarray(jsa.spec_augment(key, jnp.asarray(x), jcfg))
        got = tsa.apply_spec_augment(t(x), draw, tcfg).numpy()
        close(got, want, 1e-6, f"seed {seed}")
    ws = {w for _, w in seen}
    assert {5, 6} == {c for c, _ in seen} and {1, 11} <= ws
    x10 = _feats((2, 10, 6), 2)
    assert spec_draw(jax.random.PRNGKey(0), x10.shape, tcfg).warp is None
    np.testing.assert_array_equal(np.asarray(jsa.spec_augment(
        jax.random.PRNGKey(0), jnp.asarray(x10), jcfg)), x10)


def test_port_draws_stay_in_range():
    """The port's own draws: c ∈ [w, T−w), w ∈ [c−w+1, c+w], lengths in
    [w0, w1), positions in [0, D − max_len)."""
    cfg = tsa.SpecAugmentConfig()
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        d = tsa.draw_spec_augment(gen, (3, 40, 20), cfg)
        c, w = int(d.warp[0]), int(d.warp[1])
        assert 5 <= c < 35 and c - 4 <= w <= c + 5
        for m, D in ((d.time, 40), (d.freq, 20)):
            assert 0 <= int(m.length.min()) and int(m.length.max()) < 20
            assert 0 <= int(m.pos.min())
            assert int(m.pos.max()) < max(1, D - int(m.length.max()))


def _small_hybrids(spec):
    jcfg, tcfg = configs()
    jm = JHybrid(raw_branch=JRawNet3(nOut=24, C=64, context_dim=96),
                 ecapa=JECAPA(**ECAPA_SMALL, log_input=False, input_norm=True),
                 frontend=JCfg(), frontend_backend="xla",
                 spec_augment=jcfg if spec else None)
    tm = thybrids.RawECAPAHybrid(
        raw_branch=TRawNet3(nOut=24, C=64, context_dim=96),
        ecapa=TECAPA(n_mels=80, **ECAPA_SMALL, log_input=False,
                     input_norm=True),
        frontend=TCfg(), frontend_backend="pallas",
        spec_augment=tcfg if spec else None)
    return jm, tm, tcfg


def test_hybrid_featurize_in_training_and_not_in_eval(monkeypatch):
    x = (0.1 * np.random.default_rng(3).normal(0, 1, (4, 4000))).astype(
        np.float32)
    jm, tm, tcfg = _small_hybrids(spec=True)
    v = init_pair(jm, tm, jnp.asarray(x))
    eval_state = {k: v.clone() for k, v in tm.state_dict().items()}
    keys = keys_used(monkeypatch, jhybrids)
    want, _ = jm.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"],
                       rngs={"specaug": jax.random.PRNGKey(7)})
    tm.train()
    draw = spec_draw(keys[0], (4, 51, 80), tcfg)
    with torch.no_grad():
        got = tm(t(x), rng=draw).numpy()
    close(got[:, :16], np.asarray(want)[:, :16], 1e-4, "train ECAPA half")
    # without the draw in training: refused; in eval: no SpecAugment
    with pytest.raises(ValueError, match="generator"):
        tm(t(x))
    tm.load_state_dict(eval_state)      # the training forward moved BN's
    tm.eval()
    with torch.no_grad():
        plain = tm(t(x)).numpy()
    close(plain, np.asarray(jm.apply(v, jnp.asarray(x))), 1e-4, "eval")
    jm0, _, _ = _small_hybrids(spec=False)
    close(plain, np.asarray(jm0.apply(v, jnp.asarray(x))), 1e-4, "no spec")


def test_encoder_spec_augment_matches_jax(monkeypatch):
    """ECAPA_TDNN on mel features: SpecAugment in ``SpeakerEncoder``
    after the frontend, before the backbone."""
    jcfg, tcfg = configs()
    x = (0.1 * np.random.default_rng(4).normal(0, 1, (4, 4000))).astype(
        np.float32)
    jm = JEncoder(backbone=JECAPA(**ECAPA_SMALL), frontend_backend="xla",
                  spec_augment=jcfg)
    tm = TEncoder(backbone=TECAPA(n_mels=80, **ECAPA_SMALL),
                  frontend_backend="pallas", spec_augment=tcfg)
    v = init_pair(jm, tm, jnp.asarray(x))
    keys = keys_used(monkeypatch, jencoder)
    for seed in range(2):
        want, _ = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"],
                           rngs={"specaug": jax.random.PRNGKey(seed)})
        tm.train()
        with torch.no_grad():
            got = tm(t(x), rng=spec_draw(keys[-1], (4, 51, 80),
                                         tcfg)).numpy()
        close(got, np.asarray(want), 1e-4, f"seed {seed}")


def _raw3_h(**kw):
    return {"audio_spec": {"sample_rate": 8000, "sentence_len": 0.5},
            "features": "raw", "model": {"name": "Raw3_ECAPA",
                                         "feature_type": "raw", "nOut": 512},
            "augment_options": {"augment_chain": ["env_corrupt",
                                                  "spec_domain"]}, **kw}


@pytest.mark.parametrize("augment,chain,on", [
    (True, ["env_corrupt", "spec_domain"], True),
    (False, ["env_corrupt", "spec_domain"], False),
    (True, ["env_corrupt", "time_domain"], False)])
def test_builder_sets_spec_augment(augment, chain, on):
    h = _raw3_h(augment=augment,
                augment_options={"augment_chain": chain})
    enc = TB.encoder_from_hparams(h)
    assert (enc.backbone.spec_augment is not None) == on
    assert (enc.spec_augment is not None) == on


def test_raw3_ecapa_forward_augments_its_mel_branch_in_training_only(
        monkeypatch):
    """Full-width ``Raw3_ECAPA`` from the builder: the features that reach
    its ECAPA branch (stopped there, so the wide branches never run) are
    the augmented ones in training and the plain ones in eval."""
    enc = TB.encoder_from_hparams(_raw3_h(augment=True))
    hyb = enc.backbone
    x = (0.1 * np.random.default_rng(5).normal(0, 1, (2, 4000))).astype(
        np.float32)
    seen = []

    class Stop(Exception):
        pass

    def capture(mel):
        seen.append(mel.detach().clone())
        raise Stop
    monkeypatch.setattr(hyb.ecapa, "forward", capture)
    plain = thybrids.hybrid_featurize(t(x), "melspectrogram", hyb.frontend,
                                      None, "xla")
    draw = tsa.draw_spec_augment(torch.Generator().manual_seed(1),
                                 plain.shape, hyb.spec_augment)
    for mode in ("train", "eval"):
        getattr(enc, mode)()
        with pytest.raises(Stop):
            enc(t(x), rng=draw)
    torch.testing.assert_close(
        seen[0], tsa.apply_spec_augment(plain, draw, hyb.spec_augment))
    torch.testing.assert_close(seen[1], plain)
    assert not torch.equal(seen[0], seen[1])
