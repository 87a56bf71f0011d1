"""Every RawNet2-family builder at its full width through
``SpeakerEncoder``, port against the JAX package (CPU, fp32 eval).

Each model is built by ``encoder_from_hparams`` in both packages from
its yaml (the builder pins the widths: ECAPA-192 at 512/1536 channels,
RawNet2Custom at (128, 128, 256, 256, 512, 512), GRU 1024), with the
crop cut to 9,000 samples so that the GRU and the pooling see four time
steps. The JAX init's tree is carried over by ``params_from_jax``, which
raises on any leaf left over or missing, BatchNorm statistics
randomized. Tolerance: 2e-5 of the largest embedding magnitude (two
fp32 forwards of ~40 layers, sums in different orders).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import builder as JB
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.config import read_config

from test_torch_port_helpers import close, init_pair, t

ROOT = Path(__file__).resolve().parents[1]
T = 9000
# (model, the yaml that names it or whose audio keys it takes)
BUILDERS = [("Raw_ECAPA", "verification.yaml"),
            ("Raw_ECAPA_sinc_asp", "voxceleb_raw_ecapa.yaml"),
            ("Raw_ECAPA_conv_asp", "voxceleb_raw_ecapa.yaml"),
            ("Raw_ECAPA_sinc_gru", "dataprep.yaml"),
            ("Raw_ECAPA_hype", "voxceleb_raw_ecapa.yaml"),
            ("RawNet2_custom", "vlsp_rawnet2.yaml"),
            ("RawNet2", "vlsp_rawnet2.yaml"),
            ("RawNet_baseline", "vlsp_rawnet2.yaml")]


def hparams_for(model: str, yaml_name: str, samples: int = T) -> dict:
    """The yaml's keys with ``model.name`` set and crops of ``samples``."""
    h = read_config(ROOT / "yaml" / yaml_name)
    spec = dict(h["audio_spec"])
    spec["sentence_len"] = samples / spec["sample_rate"]
    return {**h, "audio_spec": spec, "frontend_backend": "xla",
            "model": {**h["model"], "name": model}}


@pytest.mark.parametrize("model,yaml_name", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_builder_through_speaker_encoder(model, yaml_name):
    h = hparams_for(model, yaml_name)
    jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    tm = TB.encoder_from_hparams(h)
    x = (0.1 * np.random.default_rng(0).normal(0, 1, (2, T))).astype(
        np.float32)
    v = init_pair(jm, tm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, 512)
    close(got, ref, 2e-5, model)
    if model.startswith("RawNet"):
        # a standalone raw model: no in-model featurizer, so the encoder
        # hands it the wave through the raw pass-through frontend
        assert tm.feature_type == "raw"
        assert not hasattr(tm.backbone, "frontend")
        with torch.no_grad():
            direct = tm.backbone(t(x)).numpy()
        np.testing.assert_array_equal(got, direct)


def test_rawnet2_custom_builder_keys_follow_jax():
    """The builders read the sinc bank's rate as the JAX builders do
    (``sample_rate``, else ``audio_spec``, else 16 kHz) and size the
    sample LayerNorm to the crop."""
    h = hparams_for("Raw_ECAPA", "verification.yaml")
    raw = TB.encoder_from_hparams(h).backbone.raw_branch
    assert raw.SincConv_0.sample_rate == 8000
    assert raw.SampleLayerNorm_0.gamma.shape == (T,)
    assert raw.front_proc == "sinc" and raw.aggregate == "asp"
    h = hparams_for("RawNet2_custom", "vlsp_rawnet2.yaml", samples=32000)
    m = TB.encoder_from_hparams(h).backbone
    assert (m.front_proc, m.aggregate) == ("sinc", "gru")
    assert m.SincConv_0.sample_rate == 16000
    assert m.SampleLayerNorm_0.gamma.shape == (32000,)


def test_int8_of_the_family_is_refused_by_name(tmp_path):
    """int8 extraction of the RawNet2 family is not held against the JAX
    package yet: the engine refuses it rather than serve unchecked
    numbers."""
    from speakerverification_tpu_torch.inference import InferenceEngine
    h = {**hparams_for("Raw_ECAPA_conv_asp", "voxceleb_raw_ecapa.yaml"),
         "quant": "int8", "save_folder": str(tmp_path)}
    with pytest.raises(NotImplementedError, match="int8 of RawNet2Custom"):
        InferenceEngine(h, device="cpu")


@pytest.mark.parametrize("name", ["RawNet2", "RawNet2_custom",
                                  "Raw_ECAPA_conv_asp"])
def test_int8_quantization_refuses_the_family(name):
    """The refusal lives in ``quant.py``: calibrating or quantizing any
    model that holds a RawNet2-family module raises, whatever calls it."""
    from speakerverification_tpu_torch.quant import (
        calibrate_act_scales,
        quantize_model,
    )
    model = TB.encoder_from_hparams(hparams_for(name, "voxceleb_raw_ecapa.yaml"))
    with pytest.raises(NotImplementedError, match="int8 of RawNet2"):
        quantize_model(model)
    with pytest.raises(NotImplementedError, match="int8 of RawNet2"):
        calibrate_act_scales(model, torch.zeros(1, T))
