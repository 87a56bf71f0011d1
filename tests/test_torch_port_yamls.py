"""Every yaml of the repository built by the port on the CPU, at its own
widths, with no forward: the model, its loss head, the optimizer and the
schedule. The port's parameters and BatchNorm statistics, as flax trees
(``weights.params_to_jax``), have the names and shapes of the JAX
package's init of the same yaml (traced with ``jax.eval_shape``, nothing
compiled). ``model_plot.yaml`` (``Conformer``, ported last) has a test
of its own; its forward is held to JAX's in
``test_torch_port_conformer.py``.
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
    _builds_like_jax(name)


def _builds_like_jax(name: str):
    h = read_config(ROOT / "yaml" / name)
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
