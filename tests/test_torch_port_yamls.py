"""Every yaml of the repository built by the port on the CPU, at its own
widths, with no forward: the model, its loss head, the optimizer and the
schedule. The port's parameters and BatchNorm statistics, as flax trees
(``weights.params_to_jax``), have the names and shapes of the JAX
package's init of the same yaml (traced with ``jax.eval_shape``, nothing
compiled). ``model_plot.yaml`` (``Conformer``) has a test of its own;
its forward is held to JAX's in ``test_torch_port_conformer.py``. The
zoo that no yaml names (the ResNetSE, SE-ResNet and TitaNet families,
``Tita_ECAPA``, ``Raw_tita``, ``Res_ECAPA``) is built on
``ecapa_tdnn.yaml``'s keys, each name in both registries.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from speakerverification_tpu import builder as JB
from speakerverification_tpu_torch import builder as TB
from speakerverification_tpu_torch.config import read_config
from speakerverification_tpu_torch.data.audio import AudioSpec
from speakerverification_tpu_torch.weights import params_to_jax

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted(p.name for p in (ROOT / "yaml").glob("*.yaml")
               if p.name != "model_plot.yaml")


def test_every_yaml_but_model_plot_is_listed():
    assert len(YAMLS) == 11


@pytest.mark.parametrize("name", YAMLS)
def test_port_builds_the_yaml(name):
    torch.set_num_threads(2)
    _builds_like_jax(name)


def _builds_like_jax(name: str):
    return _hparams_build_like_jax(read_config(ROOT / "yaml" / name))


def _hparams_build_like_jax(h: dict):
    model = TB.encoder_from_hparams(h, with_loss=True)
    tx = TB.optimizer_from_hparams(h)
    sched, unit = TB.scheduler_from_hparams(h, steps_per_epoch=100)
    assert model.loss is not None and unit in ("iteration", "epoch")
    assert tx.init({k: p.detach() for k, p in model.named_parameters()})
    float(sched(0))

    # the JAX init of the same yaml, traced for its shapes only
    T = AudioSpec(h["audio_spec"]).max_audio
    jm = JB.encoder_from_hparams(h, with_loss=True, num_devices=1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 2, T)), jnp.zeros((2,), jnp.int32))
    params, stats = params_to_jax(model.state_dict())
    for col, tree in (("params", params), ("batch_stats", stats)):
        want = {k: tuple(v.shape)
                for k, v in flatten_dict(shapes.get(col, {})).items()}
        got = {k: tuple(v.shape) for k, v in flatten_dict(tree).items()}
        assert got == want, (name, col, sorted(set(got) ^ set(want))[:8])


    return model


def test_model_plot_builds_and_matches_jax():
    model = _builds_like_jax("model_plot.yaml")
    assert type(model.backbone).__name__ == "ConformerSpeaker"
    assert type(model.loss).__name__ == "AAmSoftmaxAP"
    assert model.loss.AAmSoftmax_0.weight.shape == (5994, 512)


# the tenth slice's names: ResNetSE (7), SE-ResNet (5), TitaNet, hybrids2
ZOO_NAMES = ["ResNetSE34", "ResNetSE34V2", "ResNetSE50", "ResNetSE50V2",
             "ResNetSE100m2", "ResNetSE101", "ResNetSE152", "se_resnet18",
             "se_resnet34", "se_resnet50", "se_resnet101", "se_resnet152",
             "TitaNet", "Tita_ECAPA", "Raw_tita", "Res_ECAPA"]


def test_registries_agree_on_the_zoo():
    import speakerverification_tpu.models  # noqa: F401  (fills JAX's)
    from speakerverification_tpu.registry import MODELS as JAX_MODELS
    from speakerverification_tpu_torch.registry import MODELS as PORT_MODELS
    # the port's registry fills on its first build
    with pytest.raises(KeyError):
        TB.build_model("no such model")
    assert len(set(ZOO_NAMES)) == 16
    assert set(ZOO_NAMES) <= set(JAX_MODELS.names())
    assert set(ZOO_NAMES) <= set(PORT_MODELS.names())
    # every name the port registers is one of JAX's
    assert set(PORT_MODELS.names()) <= set(JAX_MODELS.names())


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_name_builds_like_jax(name):
    torch.set_num_threads(2)
    h = read_config(ROOT / "yaml" / "ecapa_tdnn.yaml")
    features = "raw" if name in ("Tita_ECAPA", "Raw_tita") else \
        "melspectrogram"
    _hparams_build_like_jax({**h, "features": features, "model": {
        "name": name, "feature_type": features, "nOut": 256}})
