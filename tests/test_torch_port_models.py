"""Port models against the JAX package at small widths, in fp32.

ECAPA_TDNN, RawNet3 (C=64), a small RawECAPAHybrid built directly in
both packages (``build_raw3_ecapa`` pins the ECAPA widths) and a
SpeakerEncoder around it. The JAX hybrid runs its plain mel frontend
(``frontend_backend='xla'``); the port's runs the mel kernel's pipeline,
which on a CPU tensor is the kernel's plain version.

Tolerance: 1e-4 of the largest embedding magnitude. Both sides are fp32,
but a model chains ~20 layers of sums taken in different orders, and
RawNet3's log(|sinc| + 1e-6) amplifies the error of near-zero filter
outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu.encoder import SpeakerEncoder as JEncoder
from speakerverification_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA
from speakerverification_tpu.models.hybrids import RawECAPAHybrid as JHybrid
from speakerverification_tpu.models.rawnet3 import RawNet3 as JRawNet3
from speakerverification_tpu.ops.frontend import FrontendConfig as JCfg
from speakerverification_tpu_torch.encoder import SpeakerEncoder as TEncoder
from speakerverification_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN as TECAPA
from speakerverification_tpu_torch.models.hybrids import RawECAPAHybrid as THybrid
from speakerverification_tpu_torch.models.rawnet3 import RawNet3 as TRawNet3
from speakerverification_tpu_torch.ops.frontend import FrontendConfig as TCfg
from speakerverification_tpu_torch.ops import mel_frontend as tmf

from test_torch_port_helpers import close, init_pair, t

REL = 1e-4
ECAPA_SMALL = dict(lin_neurons=16, channels=(32, 32, 32, 32, 96),
                   attention_channels=8, se_channels=8, res2net_scale=4)


def _wave(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).normal(0, 1, shape)).astype(np.float32)


@pytest.mark.parametrize("log_input,input_norm,backend",
                         [(True, False, "xla"), (False, True, "xla"),
                          (True, False, "pallas")])
def test_ecapa_tdnn(log_input, input_norm, backend):
    feats = np.abs(np.random.default_rng(1).normal(0, 1, (3, 41, 20))
                   ).astype(np.float32)
    jm = JECAPA(**ECAPA_SMALL, log_input=log_input, input_norm=input_norm)
    tm = TECAPA(n_mels=20, **ECAPA_SMALL, log_input=log_input,
                input_norm=input_norm, conv_backend=backend)
    v = init_pair(jm, tm, jnp.asarray(feats))
    ref = jm.apply(v, jnp.asarray(feats))
    with torch.no_grad():
        got = tm(t(feats)).numpy()
    close(got, ref, REL, "ECAPA_TDNN")


def _small_raw3():
    return (JRawNet3(nOut=24, C=64, context_dim=96),
            TRawNet3(nOut=24, C=64, context_dim=96))


def test_rawnet3():
    x = _wave((2, 4000))
    jm, tm = _small_raw3()
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, REL, "RawNet3")


def _small_hybrid():
    cfg_j, cfg_t = JCfg(), TCfg()
    jraw, traw = _small_raw3()
    jm = JHybrid(raw_branch=jraw,
                 ecapa=JECAPA(**ECAPA_SMALL, log_input=False, input_norm=True),
                 frontend=cfg_j, frontend_backend="xla")
    tm = THybrid(raw_branch=traw,
                 ecapa=TECAPA(n_mels=cfg_t.n_mels, **ECAPA_SMALL,
                              log_input=False, input_norm=True),
                 frontend=cfg_t, frontend_backend="pallas")
    return jm, tm


def test_raw_ecapa_hybrid():
    x = _wave((2, 4000), seed=2)
    jm, tm = _small_hybrid()
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    before = tmf.launches
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert tmf.launches == before          # CPU tensors never launch
    assert got.shape == (2, 16 + 24)
    close(got[:, :16], ref[:, :16], REL, "hybrid ecapa half")
    close(got[:, 16:], ref[:, 16:], REL, "hybrid raw half")


def test_speaker_encoder_grouped():
    x = _wave((2, 2, 4000), seed=3)
    jh, th = _small_hybrid()
    jm = JEncoder(backbone=jh, feature_type="raw", frontend_backend="xla")
    tm = TEncoder(backbone=th, feature_type="raw")
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, 2, 40)
    close(got, ref, REL, "SpeakerEncoder")
    # labels need a loss head, which this encoder was built without
    with pytest.raises(ValueError, match="without a loss head"):
        tm(t(x), label=torch.zeros(2, dtype=torch.long))


def test_speaker_encoder_mel_features():
    x = _wave((3, 4000), seed=4)
    jm = JEncoder(backbone=JECAPA(**ECAPA_SMALL), frontend_backend="xla")
    tm = TEncoder(backbone=TECAPA(n_mels=80, **ECAPA_SMALL),
                  frontend_backend="pallas")
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    close(got, ref, REL, "SpeakerEncoder(ECAPA)")
