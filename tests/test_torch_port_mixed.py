"""The list-valued ``model.name`` (``models/mixed.py``), port against the
JAX package (CPU), mirroring ``tests/test_mixed_model.py``.

* The forward through ``encoder_from_hparams`` against JAX's, eval mode,
  at ``tests/test_mixed_model.py``'s tiny widths (RawNet3 C 16 ∥ ECAPA
  16/48 channels, 8 kHz, 1 s waves): the split ``[32, 16]``, and the
  default even split of 33 over two mel branches (ECAPA ∥ TitaNet-S),
  which share one featurization. Tolerance 1e-4 of the largest value
  (RawNet3's log(|sinc| + 1e-6), as in ``test_torch_port_models.py``).
* The builder's surface: validation errors, ``run_dirs``' joined name,
  ``features: raw`` coerced to mel for the mel branches, top-level
  frontend overrides, mfcc's band edges under a mel-keyed config, the
  audio keys reaching the models, SpecAugment and the compute dtype
  threaded into the MixedModel and the hybrids nested in it (which get
  the uncast wave), ``conv_backend`` reaching the ECAPA branch; a
  train-mode forward with SpecAugment differs between generators, eval
  does not; a bf16 step's gradient is finite.
* The registries: the port's ``MODELS`` holds JAX's 36 names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import builder as JB
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.models import hybrids as TH
from speakerverification_tpu_torch.models.mixed import (
    MixedModel,
    build_mixed_model,
)

from test_torch_port_helpers import close, port_variables, t

SR = 8000
TINY_ECAPA = {"channels": [16, 16, 16, 16, 48], "attention_channels": 4,
              "res2net_scale": 4, "se_channels": 4}
TINY_RAW3 = {"C": 16, "model_scale": 8}
TINY_TITA = {"model_size": "s", "n_mega_blocks": 2, "hidden_size": 32,
             "mega_block_kernel": 3}


def hparams(model: dict, **extra) -> dict:
    return {"model": model,
            "criterion": {"name": "AAmSoftmax", "margin": 0.2, "scale": 30},
            "nClasses": 4, "features": "melspectrogram", "n_mels": 24,
            "frontend_backend": "xla",
            "audio_spec": {"sample_rate": SR, "sentence_len": 1.0,
                           "win_len": 0.025, "hop_len": 0.01}, **extra}


SPLIT = {"name": ["RawNet3", "ECAPA_TDNN"], "nOut": 48, "nOuts": [32, 16],
         "branch_options": [TINY_RAW3, TINY_ECAPA]}
EVEN = {"name": ["ECAPA_TDNN", "TitaNet"], "nOut": 33,
        "branch_options": [TINY_ECAPA, TINY_TITA]}


def waves(n: int, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(0, 1, (n, SR))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    """Per config: the port's encoder (eval, weights carried to JAX) and
    JAX's eval embeddings on 2 waves."""
    torch.set_num_threads(2)
    out = {}
    for name, model in (("split", SPLIT), ("even", EVEN)):
        h = hparams(model)
        jm = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
        tm = TB.encoder_from_hparams(h)
        v = port_variables(tm, seed=1)
        x = waves(2, seed=2)
        out[name] = (tm, x, np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))))
    return out


@pytest.mark.parametrize("name,width", [("split", 48), ("even", 33)])
def test_mixed_forward_matches_jax(pairs, name, width):
    tm, x, ref = pairs[name]
    assert tm.feature_type == "raw"                 # the wave passes through
    assert isinstance(tm.backbone, MixedModel)
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, width)
    close(got, ref, 1e-4, f"mixed {name}")


def test_even_split_and_one_featurization_per_kind(pairs, monkeypatch):
    tm, x, _ = pairs["even"]
    widths = [b.Dense_0.out_features if hasattr(b, "Dense_0") else None
              for b in tm.backbone.branches]
    assert widths[0] == 17                      # remainder to the first
    calls = []
    real = TH.hybrid_featurize

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)
    monkeypatch.setattr("speakerverification_tpu_torch.models.mixed."
                        "hybrid_featurize", counted)
    with torch.no_grad():
        tm(t(x))
    assert calls == ["melspectrogram"]


def test_validation_errors():
    with pytest.raises(ValueError, match="sum"):
        build_mixed_model(["RawNet3", "ECAPA_TDNN"], nOut=48, nOuts=[32, 32])
    with pytest.raises(ValueError, match=">= 2"):
        build_mixed_model(["RawNet3"], nOut=48)
    with pytest.raises(KeyError, match="unknown model"):
        build_mixed_model(["RawNet3", "NoSuchNet"], nOut=48)
    with pytest.raises(ValueError, match="feature_types"):
        build_mixed_model(["RawNet3", "ECAPA_TDNN"], nOut=48,
                          feature_types=["raw"])
    with pytest.raises(ValueError, match="branch_options"):
        build_mixed_model(["RawNet3", "ECAPA_TDNN"], nOut=48,
                          branch_options=[{}])


def test_run_dirs_join(tmp_path):
    from speakerverification_tpu.training.trainer import run_dirs as jdirs
    from speakerverification_tpu_torch.inference import run_dirs
    h = {"save_folder": str(tmp_path),
         "model": {"name": ["RawNet3", "ECAPA_TDNN"]},
         "criterion": {"name": "AAmSoftmax"}}
    dirs = run_dirs(h)
    assert dirs["root"].name == "AAmSoftmax"
    assert dirs["root"].parent.name == "RawNet3+ECAPA_TDNN"
    assert dirs["root"] == jdirs(h)["root"]


def test_raw_shared_feature_type_coerces_to_mel():
    h = hparams(SPLIT, features="raw")
    enc = TB.encoder_from_hparams(h)
    assert enc.backbone.input_kinds == ("raw", "melspectrogram")
    assert enc.feature_type == "raw"
    jenc = JB.encoder_from_hparams(h, with_loss=False, num_devices=1)
    assert jenc.backbone.input_kinds == enc.backbone.input_kinds


def test_toplevel_frontend_overrides():
    h = hparams(SPLIT, n_fft=256, win_length=160, hop_length=64, fmax=3500.0)
    fe = TB.encoder_from_hparams(h).backbone.frontend
    assert (fe.n_fft, fe.win_length, fe.hop_length, fe.fmax) == (
        256, 160, 64, 3500.0)


def test_mfcc_branch_gets_mfcc_band_edges():
    h = hparams({"name": ["ECAPA_TDNN", "ECAPA_TDNN"], "nOut": 32,
                 "nOuts": [16, 16],
                 "feature_types": ["melspectrogram", "mfcc"],
                 "branch_options": [TINY_ECAPA, TINY_ECAPA]})
    cfgs = dict(TB.encoder_from_hparams(h).backbone.frontends)
    jcfgs = dict(JB.encoder_from_hparams(h, with_loss=False,
                                         num_devices=1).backbone.frontends)
    assert (cfgs["melspectrogram"].fmin, cfgs["melspectrogram"].fmax) == \
        (0.0, None)
    assert (cfgs["mfcc"].fmin, cfgs["mfcc"].fmax) == (10.0, 4000.0)
    for kind in ("melspectrogram", "mfcc"):
        assert (cfgs[kind].fmin, cfgs[kind].fmax, cfgs[kind].n_mels) == (
            jcfgs[kind].fmin, jcfgs[kind].fmax, jcfgs[kind].n_mels)
    h2 = dict(h, fmin=25.0, fmax=3000.0)
    for cfg in dict(TB.encoder_from_hparams(h2).backbone.frontends).values():
        assert (cfg.fmin, cfg.fmax) == (25.0, 3000.0)
    # the mfcc branch's features: one mixed forward runs both kinds
    with torch.no_grad():
        out = TB.encoder_from_hparams(h).eval()(t(waves(2, seed=3)))
    assert out.shape == (2, 32) and torch.isfinite(out).all()


def test_audio_keys_and_backend_reach_nested_hybrids():
    h = hparams({"name": ["RawNet3", "Tita_ECAPA"], "nOut": 288,
                 "nOuts": [32, 256], "branch_options": [TINY_RAW3, {}]},
                n_fft=256, win_length=160, hop_length=64)
    enc = TB.encoder_from_hparams(h)
    nested = enc.backbone.branches[1]
    assert (nested.frontend.n_fft, nested.frontend.win_length,
            nested.frontend.hop_length) == (256, 160, 64)
    assert enc.backbone.frontend_backend == "xla"
    assert nested.frontend_backend == "xla"
    with pytest.raises(ValueError, match="frontend_backend"):
        TB.encoder_from_hparams({**h, "frontend_backend": "palas"})


def test_specaugment_and_dtype_reach_the_nested_hybrid():
    h = hparams({"name": ["RawNet3", "Tita_ECAPA"], "nOut": 288,
                 "nOuts": [32, 256], "branch_options": [TINY_RAW3, {}]},
                mixedprec=True, augment=True,
                augment_options={"augment_chain": ["spec_domain"]})
    mixed = TB.encoder_from_hparams(h).backbone
    assert mixed.spec_augment is not None
    assert mixed.compute_dtype == torch.bfloat16
    tita = mixed.branches[1]
    assert type(tita).__name__ == "TitaECAPA"
    assert tita.spec_augment is not None
    assert tita.compute_dtype == torch.bfloat16
    assert not hasattr(mixed.branches[0], "spec_augment")


def test_nested_hybrid_gets_the_uncast_wave():
    h = hparams({"name": ["RawNet3", "Tita_ECAPA"], "nOut": 288,
                 "nOuts": [32, 256], "branch_options": [TINY_RAW3, {}]},
                mixedprec=True)
    mixed = TB.encoder_from_hparams(h).backbone.eval()
    seen = []
    for b in mixed.branches:
        b.register_forward_pre_hook(
            lambda m, args: seen.append((type(m).__name__, args[0].dtype)))
    from speakerverification_tpu_torch.weights import cast_copy
    with torch.no_grad():
        cast_copy(mixed, torch.bfloat16).eval()(t(waves(2, seed=4)))
    assert ("RawNet3", torch.bfloat16) in seen
    assert ("TitaECAPA", torch.float32) in seen


def test_specaugment_reaches_the_in_model_features():
    h = hparams(SPLIT, augment=True,
                augment_options={"augment_chain": ["spec_domain"]})
    enc = TB.encoder_from_hparams(h)
    assert enc.backbone.spec_augment is not None
    x = t(waves(2, seed=5))
    g = torch.Generator()
    with torch.no_grad():
        a = enc.train()(x, rng=g.manual_seed(1)).numpy()
        b = enc.train()(x, rng=g.manual_seed(2)).numpy()
        e1 = enc.eval()(x, rng=g.manual_seed(1)).numpy()
        e2 = enc.eval()(x, rng=g.manual_seed(2)).numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert not np.allclose(a[:, 32:], b[:, 32:])    # the ECAPA branch
    np.testing.assert_array_equal(e1, e2)


def test_bf16_train_step_gradient_is_finite():
    from speakerverification_tpu_torch.weights import cast_copy
    h = hparams(SPLIT, mixedprec=True)
    enc = TB.encoder_from_hparams(h, with_loss=True)
    assert enc.backbone.compute_dtype == torch.bfloat16
    # the parameters in bf16, as the train step casts them
    enc = cast_copy(enc, torch.bfloat16).train()
    x = t(waves(4, seed=6)).reshape(4, 1, SR)
    loss, _ = enc(x, torch.tensor([0, 1, 2, 3]), rng=torch.Generator())
    grads = torch.autograd.grad(loss, [p for p in enc.parameters()
                                       if p.requires_grad],
                                allow_unused=True)
    total = sum(float(g.abs().sum()) for g in grads if g is not None)
    assert np.isfinite(float(loss.detach())) and np.isfinite(total) \
        and total > 0


def test_conv_backend_reaches_the_ecapa_branch():
    h = hparams({**SPLIT, "conv_backend": "pallas"})
    mixed = TB.encoder_from_hparams(h).backbone
    backends = {m.backend for m in mixed.branches[1].modules()
                if type(m).__name__ == "Res2NetBlock"}
    assert backends == {"pallas"}


def test_registries_hold_the_same_names():
    import speakerverification_tpu.models  # noqa: F401  (fills JAX's)
    from speakerverification_tpu.registry import MODELS as JAX_MODELS
    from speakerverification_tpu_torch.registry import MODELS as PORT_MODELS
    TB.fill_registry()
    assert PORT_MODELS.names() == JAX_MODELS.names()
    assert len(PORT_MODELS.names()) == 36


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_mixed_hparams_mirror_the_yaml():
    """Path M3's keys are ``yaml/raw3_ecapa.yaml``'s but for the model."""
    from pathlib import Path

    from speakerverification_tpu_torch.config import read_config
    from test_torch_port_conformer_cli import _subset_of
    smoke = _chip_smoke()
    h = {k: v for k, v in smoke.MIXED_HPARAMS.items()
         if k not in ("model", "num_eval")}
    _subset_of(h, read_config(Path(__file__).resolve().parents[1] / "yaml"
                              / "raw3_ecapa.yaml"), "raw3_ecapa.yaml: ")
    assert smoke.MIXED_HPARAMS["model"]["name"] == ["RawNet3", "ECAPA_TDNN"]


@pytest.mark.parametrize("model", ["EfficientNet", "EfficientNetv2",
                                   "RepVGG", "SCnet", "DPN", "RawNeXt",
                                   "ResNeXt", "RawNet3", "Mixed"])
def test_chip_smoke_model_zoo_quant_table_is_what_the_model_quantizes(model):
    """One int8 forward of a 2 s crop through the engine (the default
    floors): the K3 shapes it logs, per crop, are path M4's table (160
    crops a batch)."""
    from speakerverification_tpu_torch.inference import InferenceEngine
    torch.set_num_threads(2)
    smoke = _chip_smoke()
    h = (smoke.MIXED_HPARAMS if model == "Mixed" else smoke.m_hparams(
        model, {**smoke.M_IMAGE, **smoke.M_RAW}[model]))
    engine = InferenceEngine({**h, "quant": "int8"}, device="cpu")
    wave = (0.1 * np.random.default_rng(0).normal(
        0, 1, (1, smoke.crop_samples(h)))).astype(np.float32)
    engine.embed_fn(wave)
    with smoke.quant_shape_log() as shapes:
        engine.embed_fn(wave)
    got = {}
    for (shape, n, _), calls in shapes.items():
        key = (tuple(shape[1:]), n)
        got[key] = got.get(key, 0) + calls
    want = {}
    for x_shape, n, per_fwd, _ in smoke.m_quant_table(model):
        assert x_shape[0] == 160
        want[(tuple(x_shape[1:]), n)] = per_fwd
    assert got == want
    assert len(engine.act_scales) == sum(want.values())


def test_a_hybrid_narrower_than_its_mel_branch_fails():
    """``Tita_ECAPA`` at nOut 64 leaves its TitaNet 64 − 192 wide: JAX
    builds the MixedModel (flax sizes layers at init) and fails at init;
    the port, which sizes them at construction, fails at the build
    (ROADMAP C.14). ``tests/test_mixed_model.py`` builds such a config
    without running it."""
    from speakerverification_tpu.models.mixed import (
        build_mixed_model as jax_build,
    )
    kw = dict(nOut=96, nOuts=[32, 64], branch_options=[TINY_RAW3, {}],
              n_mels=24)
    jm = jax_build(["RawNet3", "Tita_ECAPA"], **kw)
    with pytest.raises(Exception):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, SR), jnp.float32))
    with pytest.raises(RuntimeError, match="negative dimension"):
        build_mixed_model(["RawNet3", "Tita_ECAPA"], **kw)
