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
    torch.set_num_threads(2)
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


def test_engine_serves_int8_of_the_asp_family(tmp_path):
    """``quant: int8`` of a RawNet2-family model whose calibration works in
    the JAX package: the engine calibrates the raw branch's convs and
    Denses as well as the ECAPA branch's, under JAX's keys, and its
    embeddings stay near the float engine's (cosine >= 0.99, the bar of
    chip_smoke's int8 paths). Scales and embeddings against JAX are held
    in ``test_torch_port_rawnet2_int8.py``."""
    torch.set_num_threads(2)
    from speakerverification_tpu_torch.inference import InferenceEngine
    h = {**hparams_for("Raw_ECAPA_conv_asp", "voxceleb_raw_ecapa.yaml"),
         "save_folder": str(tmp_path)}
    x = (0.1 * np.random.default_rng(1).normal(0, 1, (3, T))).astype(
        np.float32)
    float_emb = InferenceEngine(h, device="cpu").embed_fn(x).numpy()
    engine = InferenceEngine({**h, "quant": "int8"}, device="cpu")
    got = engine.embed_fn(x).numpy()
    raw = sorted(k for k in engine.act_scales
                 if k.startswith("backbone/raw_branch/"))
    assert "backbone/raw_branch/RawNetBasicBlock_5/Conv_2" in raw
    assert "backbone/raw_branch/Dense_0" in raw and len(raw) == 16
    cos = np.sum(got * float_emb, 1) / (np.linalg.norm(got, axis=1)
                                        * np.linalg.norm(float_emb, axis=1))
    assert cos.min() >= 0.99, cos


GRU_MODELS = [("RawNet2", "vlsp_rawnet2.yaml"),
              ("RawNet2_custom", "vlsp_rawnet2.yaml"),
              ("Raw_ECAPA_sinc_gru", "dataprep.yaml"),
              ("Raw_ECAPA_hype", "voxceleb_raw_ecapa.yaml")]


@pytest.mark.parametrize("model,yaml_name", GRU_MODELS,
                         ids=[m for m, _ in GRU_MODELS])
def test_int8_calibration_refuses_the_gru_models(model, yaml_name,
                                                 tmp_path):
    """Static int8 of a model whose GRU has a layer to quantize fails in
    the JAX package (its calibration cannot read a layer's input inside
    ``nn.RNN``'s scan; ``test_torch_port_rawnet2_int8`` holds that side):
    the port refuses it by name, in ``calibrate_act_scales`` and in the
    int8 engine, while dynamic int8 quantizes the GRU."""
    from speakerverification_tpu_torch.inference import InferenceEngine
    from speakerverification_tpu_torch.quant import (
        QuantLinear,
        calibrate_act_scales,
        quantize_model,
    )
    h = hparams_for(model, yaml_name)
    tm = TB.encoder_from_hparams(h)
    reason = r"GRU \(.*GRUCell_0\).*nn\.RNN's scan"
    with pytest.raises(NotImplementedError, match=reason):
        calibrate_act_scales(tm, torch.zeros(1, T))
    with pytest.raises(NotImplementedError, match=reason):
        InferenceEngine({**h, "quant": "int8",
                         "save_folder": str(tmp_path)}, device="cpu")
    gru = next(m for n, m in quantize_model(tm).named_modules()
               if n.endswith("GRUCell_0"))
    assert isinstance(gru.hr, QuantLinear)
