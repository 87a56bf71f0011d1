"""The class-sharded head over a data 2 x model 2 layout of 4 gloo ranks,
against the JAX package's ``make_dp_tp_train_step`` on 4 virtual CPU
devices and against the unsharded step, on the same seeded inputs and
the JAX init's weights.

One group of 4 ranks runs every case once
(``_torch_port_parallel_workers.case_tp``). Tolerances are JAX's own
(``test_tensor_parallel.py``): SGD without momentum, loss and precision
1e-5 relative, parameters rtol 2e-5, atol 2e-6, the head's rows
gathered.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from speakerverification_tpu.encoder import SpeakerEncoder as JEncoder
from speakerverification_tpu.losses import ShardedAAmSoftmax as JSharded
from speakerverification_tpu.losses import build_loss as jloss
from speakerverification_tpu.optim import build_optimizer as jopt
from speakerverification_tpu.parallel import (
    make_dp_tp_train_step as j_tp_step,
    make_mesh as j_mesh,
    shard_batch as j_shard,
    shard_state_tp as j_shard_tp,
)
from speakerverification_tpu.training import (
    create_train_state as j_state,
    make_train_step as j_step,
)
from speakerverification_tpu.training import checkpoint as jckpt
from speakerverification_tpu_torch.builder import encoder_from_hparams
from speakerverification_tpu_torch.losses import LOSSES
from speakerverification_tpu_torch.optim import build_optimizer
from speakerverification_tpu_torch.parallel import tp_state_specs
from speakerverification_tpu_torch.training import train_step as tstep

from _torch_port_parallel_workers import (
    encoder,
    flax_trees,
    run_ranks,
    state_from,
)

N_CLASSES = 16
N_OUT = 8


class _BNFree(fnn.Module):
    n_out: int = N_OUT

    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(self.n_out)(x.mean(axis=1))


def _batch():
    rng = np.random.default_rng(0)
    wave = rng.normal(0, 0.1, (8, 2, 4000)).astype(np.float32)
    label = (np.arange(8, dtype=np.int64) * 2) % N_CLASSES
    return wave, label


def _jax(loss, n_classes=N_CLASSES):
    return JEncoder(backbone=_BNFree(), loss=loss)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wave, label = _batch()
    jw, jl = jnp.asarray(wave), jnp.asarray(label.astype(np.int32))
    tx = jopt("sgd", learning_rate=0.1, momentum=0.0)
    single = _jax(jloss("AAmSoftmax", nOut=N_OUT, nClasses=N_CLASSES))
    s0 = j_state(single, tx, jax.random.PRNGKey(0), jw, jl)
    s1, m1 = jax.jit(j_step(single, tx))(s0, jw, jl, jax.random.PRNGKey(1),
                                         jnp.float32(1e-2))
    sharded = _jax(JSharded(nOut=N_OUT, nClasses=N_CLASSES))
    mesh = j_mesh(("data", "model"), shape=(2, 2),
                  devices=jax.devices()[:4])
    t0 = j_shard_tp(j_state(sharded, tx, jax.random.PRNGKey(0), jw, jl),
                    mesh)
    b = j_shard({"wave": wave, "label": label.astype(np.int32)}, mesh)
    t1, m2 = j_tp_step(sharded, tx, mesh, t0, donate=False)(
        t0, b["wave"], b["label"], jax.random.PRNGKey(1), jnp.float32(1e-2))
    m15 = _jax(jloss("AAmSoftmax", nOut=N_OUT, nClasses=15))
    p15 = j_state(m15, tx, jax.random.PRNGKey(0), jw, jl % 15).params
    inputs = {"tp": {"wave": wave, "label": label, "n_out": N_OUT,
                     "classes": N_CLASSES, "lr_sgd": 1e-2, "lr_adam": 1e-2,
                     "params": jax.device_get(s0.params),
                     "params15": jax.device_get(p15)}}
    tmp = tmp_path_factory.mktemp("tp")
    ranks = run_ranks("tp", 4, tmp / "work", inputs)
    return {"inputs": inputs, "ranks": ranks, "tmp": tmp / "work",
            "single": (float(m1["loss"]), float(m1["prec1"]),
                       jax.device_get(s1.params)),
            "dp_tp": (float(m2["loss"]), float(m2["prec1"]),
                      jax.device_get(t1.params)),
            "jax_state": s0}


def _assert_trees(got, want, rtol, atol):
    g, w = flatten_dict(got), flatten_dict(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   rtol=rtol, atol=atol, err_msg=str(k))


@pytest.mark.parametrize("ref", ["dp_tp", "single"])
def test_dp_tp_step_matches_jax(run, ref):
    loss, prec1, params = run[ref]
    for r in run["ranks"]:
        got = r["sgd"]
        np.testing.assert_allclose(got["loss"][0], loss, rtol=1e-5)
        np.testing.assert_allclose(got["prec1"], prec1, rtol=1e-5)
        _assert_trees(got["params"], params, 2e-5, 2e-6)


def test_dp_tp_step_matches_the_ports_unsharded_step(run):
    c = run["inputs"]["tp"]
    model = encoder("bnfree", "AAmSoftmax", n_out=N_OUT,
                    n_classes=N_CLASSES)
    tx = build_optimizer("sgd", learning_rate=1e-2, momentum=0.0)
    state = state_from(model, tx, c["params"])
    state, m = tstep.make_train_step(model, tx)(
        state, torch.from_numpy(c["wave"]), torch.from_numpy(c["label"]),
        1e-2)
    got = run["ranks"][0]["sgd"]
    np.testing.assert_allclose(got["loss"][0], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["prec1"], float(m["prec1"]), rtol=1e-5)
    _assert_trees(got["params"], flax_trees(state)[0], 2e-5, 2e-6)


def test_each_rank_holds_its_rows_and_the_shards_name_them(run):
    for r in run["ranks"]:
        assert r["sgd"]["head_rows"] == (N_CLASSES // 2, N_OUT)
        # the weight, and under Adam its two moments
        assert len(r["adam"]["sharded"]) == 3
        assert all(p.endswith("loss.weight") for p in r["adam"]["sharded"])
        assert r["sgd"]["sharded"] == ["params/loss.weight"]


def test_dp_tp_adam_steps_stay_finite_and_learn(run):
    for r in run["ranks"]:
        losses = r["adam"]["loss"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert len({tuple(r["adam"]["loss"]) for r in run["ranks"]}) == 1


def test_model_ranks_keep_equal_backbones(run):
    ref = run["ranks"][0]["backbone"]
    for r in run["ranks"][1:]:
        for k, v in ref.items():
            assert torch.equal(v, r["backbone"][k]), k


def test_msgpack_of_the_sharded_state_keeps_the_jax_layout(run):
    """Every rank gathers the head's rows, rank 0 writes: the JAX
    package's own loader restores the file as its train state."""
    target = j_state(
        _jax(jloss("AAmSoftmax", nOut=N_OUT, nClasses=N_CLASSES)),
        jopt("adam", learning_rate=1e-2), jax.random.PRNGKey(0),
        jnp.asarray(_batch()[0]), jnp.asarray(_batch()[1].astype(np.int32)))
    got = jckpt.load_checkpoint(run["tmp"] / "tp.msgpack", target)
    _assert_trees(jax.device_get(got.params), run["ranks"][0]["adam"]["params"],
                  0, 0)
    # Adam's two moments of the head, whole
    shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(got.opt_state)]
    assert shapes.count((N_CLASSES, N_OUT)) == 2


def test_dp_tp_refuses_a_head_that_is_not_model_aware(run):
    msg = run["ranks"][0]["refused_aware"]
    assert "requires a model-axis-aware loss head" in msg
    assert "AAmSoftmax" in msg


def test_dp_tp_refuses_a_class_count_that_does_not_divide(run):
    assert "divisible by model_parallel=2" in run["ranks"][0][
        "refused_divisible"]


def test_sharded_head_is_the_plain_head_outside_a_group():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 2, N_OUT, generator=gen)
    label = torch.tensor([0, 3, 5, 7, 9, 15])
    plain = LOSSES.get("AAmSoftmax")(nOut=N_OUT, nClasses=N_CLASSES)
    shard = LOSSES.get("ShardedAAmSoftmax")(nOut=N_OUT, nClasses=N_CLASSES)
    shard.load_state_dict(plain.state_dict())
    l1, p1 = plain(x, label)
    l2, p2 = shard(x, label)
    torch.testing.assert_close(l2, l1, rtol=1e-6, atol=0)
    assert float(p1) == float(p2)
    with torch.no_grad():
        shard.weight = torch.nn.Parameter(shard.weight[:8].clone())
    with pytest.raises(RuntimeError, match="no process group is bound"):
        shard(x, label)


def test_tp_state_specs_target_only_the_loss_weight():
    model = encoder("bnfree", "ShardedAAmSoftmax", n_out=N_OUT,
                    n_classes=N_CLASSES)
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    state = create_train_state(model, build_optimizer(
        "adam", learning_rate=1e-2), 0)
    specs = tp_state_specs(state, "model", 2)
    sharded = [p for p, s in specs.items() if s == ("model", None)]
    assert len(sharded) == 3 and all("loss.weight" in p for p in sharded)
    assert not [p for p, s in tp_state_specs(state, "model", 3).items() if s]


def test_builder_maps_the_margin_head_to_its_sharded_twin():
    h = {"model": {"name": "ECAPA_TDNN", "nOut": 16,
                   "channels": [16, 16, 16, 16, 48], "attention_channels": 4,
                   "se_channels": 4, "res2net_scale": 2},
         "nClasses": 8, "model_parallel": 2}
    enc = encoder_from_hparams({**h, "criterion": {"name": "AAmSoftmax"}},
                               with_loss=True)
    assert type(enc.loss).__name__ == "ShardedAAmSoftmax"
    with pytest.raises(ValueError, match="requires a class-sharded loss "
                                         "head .ShardedAAmSoftmax., got "
                                         "ARmSoftmax"):
        encoder_from_hparams({**h, "criterion": {"name": "ARmSoftmax"}},
                             with_loss=True)
