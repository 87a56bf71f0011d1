"""Data parallelism, one process per device: the port's 2-rank gloo
groups against the JAX package's ``shard_map`` steps on the virtual CPU
devices (``tests/conftest.py``), on the same seeded inputs and the JAX
init's weights (``weights.params_from_jax``).

One group of 2 ranks runs every data-parallel case of this file once
(``_torch_port_parallel_workers.case_dp``); the tests read its results.

Tolerances: a BN-free backbone's DP step against JAX's DP step and
against JAX's one-device step: loss 1e-4 relative, parameters rtol 2e-3,
atol 2e-5 (JAX's own DP test); with BatchNorm, the DP step (each rank
normalizes its shard, the statistics are averaged) against JAX's
``accum_steps=2`` step on the whole batch, the same math
(``test_grad_accumulation_matches_dp``): SGD, loss and precision 1e-4,
parameters and statistics rtol 5e-4, atol 5e-6.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from speakerverification_tpu.encoder import SpeakerEncoder as JEncoder
from speakerverification_tpu.losses import build_loss as jloss
from speakerverification_tpu.models import build_model as jmodel
from speakerverification_tpu.optim import build_optimizer as jopt
from speakerverification_tpu.parallel import (
    make_dp_train_step as j_dp_step,
    make_mesh as j_mesh,
    replicate_state as j_replicate,
    shard_batch as j_shard,
)
from speakerverification_tpu.training import (
    create_train_state as j_state,
    make_train_step as j_step,
)
from speakerverification_tpu_torch.data.audio import write_wav
from speakerverification_tpu_torch.evaluation.evaluator import (
    extract_embeddings,
)
from speakerverification_tpu_torch.inference import make_eval_embed_fn
from speakerverification_tpu_torch.optim import build_optimizer
from speakerverification_tpu_torch.parallel import make_mesh, multihost
from speakerverification_tpu_torch.training import train_step as tstep

from _torch_port_parallel_workers import (
    SMALL_ECAPA,
    encoder,
    flax_trees,
    run_ranks,
    state_from,
)


class _BNFree(fnn.Module):
    n_out: int = 16

    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(self.n_out)(x.mean(axis=1))


def _jax_case(backbone, loss, opt, lr, wave, label, classes=8, accum=1,
              dp=False):
    bb = (_BNFree(16) if backbone == "bnfree"
          else jmodel("ECAPA_TDNN", nOut=16, **SMALL_ECAPA))
    head = (jloss(loss) if loss == "AngularProto"
            else jloss(loss, nOut=16, nClasses=classes))
    model = JEncoder(backbone=bb, loss=head)
    tx = jopt(opt, learning_rate=lr)
    s0 = j_state(model, tx, jax.random.PRNGKey(0), jnp.asarray(wave),
                 jnp.asarray(label))
    inputs = {"backbone": backbone, "loss": loss, "opt": opt, "lr": lr,
              "classes": classes, "wave": wave, "label": label,
              "params": jax.device_get(s0.params),
              "stats": jax.device_get(s0.batch_stats)}
    step = jax.jit(j_step(model, tx, accum_steps=accum))
    s1, m1 = step(s0, jnp.asarray(wave), jnp.asarray(label),
                  jax.random.PRNGKey(9), jnp.float32(lr))
    out = {"single": (float(m1["loss"]), float(m1["prec1"]),
                      jax.device_get(s1.params),
                      jax.device_get(s1.batch_stats))}
    if dp:
        mesh = j_mesh(devices=jax.devices()[:2])
        b = j_shard({"wave": wave, "label": label}, mesh)
        s2, m2 = j_dp_step(model, tx, mesh, donate=False)(
            j_replicate(s0, mesh), b["wave"], b["label"],
            jax.random.PRNGKey(9), jnp.float32(lr))
        out["dp"] = (float(m2["loss"]), float(m2["prec1"]),
                     jax.device_get(s2.params), None)
    return inputs, out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(1)
    wave = rng.normal(0, 0.1, (8, 2, 4000)).astype(np.float32)
    label = np.arange(8, dtype=np.int64)
    inputs, jax_out = {}, {}
    inputs["bnfree"], jax_out["bnfree"] = _jax_case(
        "bnfree", "AAmSoftmax", "adam", 1e-3, wave, label, dp=True)
    wave_bn = rng.normal(0, 0.1, (8, 2, 4000)).astype(np.float32)
    label_bn = rng.integers(0, 8, 8).astype(np.int64)
    inputs["bn"], jax_out["bn"] = _jax_case(
        "ecapa", "AAmSoftmax", "sgd", 1e-2, wave_bn, label_bn, accum=2)
    inputs["metric"], jax_out["metric"] = _jax_case(
        "bnfree", "AngularProto", "adam", 1e-3, wave, label)
    files = []
    for i in range(5):
        f = tmp / f"u{i}.wav"
        write_wav(f, (0.2 * rng.normal(size=800 + 37 * i)).astype(
            np.float32), 8000)
        files.append(str(f))
    inputs["files"] = files
    inputs["audio_spec"] = {"sample_rate": 8000, "sentence_len": 0.05}
    ranks = run_ranks("dp", 2, tmp / "work", inputs)
    return {"inputs": inputs, "jax": jax_out, "ranks": ranks}


def _assert_trees(got, want, rtol, atol):
    g, w = flatten_dict(got), flatten_dict(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   rtol=rtol, atol=atol, err_msg=str(k))


@pytest.mark.parametrize("ref", ["dp", "single"])
def test_dp_bnfree_step_matches_jax(run, ref):
    loss, _, params, _ = run["jax"]["bnfree"][ref]
    got = run["ranks"][0]["bnfree"]
    assert got["loss"] == pytest.approx(loss, rel=1e-4)
    _assert_trees(got["params"], params, 2e-3, 2e-5)


def test_dp_bnfree_step_matches_the_ports_one_device_step(run):
    c = run["inputs"]["bnfree"]
    model = encoder("bnfree", "AAmSoftmax")
    tx = build_optimizer("adam", learning_rate=1e-3)
    state = state_from(model, tx, c["params"])
    state, m = tstep.make_train_step(model, tx)(
        state, torch.from_numpy(c["wave"]), torch.from_numpy(c["label"]),
        1e-3)
    got = run["ranks"][0]["bnfree"]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    _assert_trees(got["params"], flax_trees(state)[0], 2e-3, 2e-5)


def test_dp_with_batchnorm_matches_jax_accumulated_step(run):
    loss, prec1, params, stats = run["jax"]["bn"]["single"]
    got = run["ranks"][0]["bn"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-4)
    np.testing.assert_allclose(got["prec1"], prec1, rtol=1e-4)
    _assert_trees(got["params"], params, 5e-4, 5e-6)
    _assert_trees(got["stats"], stats, 5e-4, 5e-6)


def test_dp_batchnorm_statistics_are_the_mean_over_ranks(run):
    """Both ranks leave the same statistics, which moved from the
    incoming ones (each rank's BatchNorm saw only its shard)."""
    a, b = (r["bn"] for r in run["ranks"])
    fa, fb = flatten_dict(a["stats"]), flatten_dict(b["stats"])
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    moved = [not torch.equal(v, torch.zeros_like(v))
             for k, v in a["stats_before"].items() if k.endswith("mean")]
    assert not any(moved)          # the incoming means were 0
    assert any(np.abs(v).max() > 0 for k, v in fa.items() if k[-1] == "mean")


def test_dp_metric_loss_gathers_global_batch(run):
    """AngularProto under DP with the gather sees the whole batch: equal
    to JAX's one-device step on it."""
    loss, _, params, _ = run["jax"]["metric"]["single"]
    got = run["ranks"][0]["metric"]
    assert got["loss"] == pytest.approx(loss, rel=1e-4)
    _assert_trees(got["params"], params, 2e-3, 2e-5)


@pytest.mark.parametrize("case", ["bnfree", "bn", "metric"])
def test_dp_ranks_apply_the_same_update(run, case):
    a, b = (r[case] for r in run["ranks"])
    assert a["loss"] == b["loss"] and a["prec1"] == b["prec1"]
    fa, fb = flatten_dict(a["params"]), flatten_dict(b["params"])
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


def test_generators_fold_in_the_data_rank(run):
    a, b = (r["draw"] for r in run["ranks"])
    assert not torch.equal(a, b)
    from speakerverification_tpu_torch.parallel.collectives import fold_in
    g = torch.Generator().manual_seed(5)
    assert torch.equal(torch.rand(4, generator=fold_in(g, 0)), a)


def test_replicate_state_broadcasts_rank_0(run):
    a, b = (r["replicated"] for r in run["ranks"])
    for k in a:
        assert torch.equal(a[k], b[k])


def test_process_allgather_stacks_in_rank_order(run):
    for r in run["ranks"]:
        got = r["allgather"]
        assert got.shape == (2, 2, 3)
        assert (got[0] == 0).all() and (got[1] == 1).all()


def test_make_mesh_refuses_a_shape_that_is_not_the_world(run):
    assert run["ranks"][0]["mesh_error"] == "mesh shape [3] != 2 devices"
    with pytest.raises(ValueError, match=r"mesh shape \[3\] != 1 devices"):
        make_mesh(("data",), shape=[3])


def test_distributed_extraction_keeps_file_order(run):
    c = run["inputs"]

    def embed_fn(w):
        w = torch.as_tensor(w)
        return torch.stack([w.mean(-1), w.std(-1), w[:, :5].sum(-1)], -1)
    want = extract_embeddings(embed_fn, c["files"], c["audio_spec"],
                              num_eval=2, batch_size=2, num_workers=1)
    for r in run["ranks"]:
        assert r["extract"].shape == tuple(want.shape) == (5, 2, 3)
        np.testing.assert_array_equal(r["extract"], want.numpy())


@pytest.mark.parametrize("B", [16, 13])
def test_eval_embed_data_parallel_is_exact(B):
    """Rows split over two devices (the CPU twice here) and gathered in
    order: the one-device embeddings, also when B does not divide."""
    model = encoder("ecapa", "AAmSoftmax")
    gen = torch.Generator().manual_seed(0)
    from speakerverification_tpu_torch.weights import init_weights_
    init_weights_(model, gen)
    wave = torch.randn(B, 4000, generator=gen) * 0.1
    single = make_eval_embed_fn(model)(wave)
    dp = make_eval_embed_fn(model, devices=["cpu", "cpu"])
    got = dp(wave)
    assert got.shape == (B, 16) and dp.devices == [torch.device("cpu")] * 2
    torch.testing.assert_close(got, single, rtol=0, atol=1e-6)


def test_eval_dp_devices_is_every_gpu_unless_turned_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tstep.eval_dp_devices({}) == [torch.device("cuda", i)
                                         for i in range(4)]
    assert tstep.eval_dp_devices({"eval_data_parallel": False}) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tstep.eval_dp_devices({}) is None


def test_rendezvous_reads_the_config_in_jax_order(monkeypatch):
    for k in ("SVTPU_COORDINATOR", "SVTPU_NUM_PROCESSES", "SVTPU_PROCESS_ID",
              "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.rendezvous({}) is None
    monkeypatch.setenv("MASTER_ADDR", "h0")
    monkeypatch.setenv("MASTER_PORT", "7")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert multihost.rendezvous({}) == ("tcp://h0:7", 4, 3)
    monkeypatch.setenv("SVTPU_COORDINATOR", "h1:9")
    monkeypatch.setenv("SVTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("SVTPU_PROCESS_ID", "1")
    assert multihost.rendezvous({}) == ("tcp://h1:9", 2, 1)
    assert multihost.rendezvous({"num_processes": 8, "process_id": 5,
                                 "coordinator_address": "file:///x"}) == (
        "file:///x", 8, 5)
    monkeypatch.delenv("SVTPU_COORDINATOR")
    assert multihost.rendezvous({"port": "123"}) == (
        "tcp://localhost:123", 2, 1)


@pytest.mark.parametrize("backend", ["mpi", "ici"])
def test_distributed_backend_refuses_mpi_and_ici(backend, capsys):
    with pytest.raises(ValueError, match=f"'{backend}' is not supported"):
        multihost.distributed_backend({"distributed_backend": backend})
    from speakerverification_tpu_torch.cli.main import main as cli_main
    assert cli_main(["--do_train", "--distributed", "--distributed_backend",
                     backend, "--config", "unused.yaml"]) == 2
    assert "not supported" in capsys.readouterr().err


def test_distributed_backend_defaults_by_device():
    assert multihost.distributed_backend({}, cuda=True) == "nccl"
    assert multihost.distributed_backend({}, cuda=False) == "gloo"
    assert multihost.distributed_backend({"distributed_backend": "gloo"},
                                         cuda=True) == "gloo"


def test_builder_gates_the_gather_on_the_process_count():
    from speakerverification_tpu_torch.builder import encoder_from_hparams
    h = {"distributed": True, "model": {"name": "ECAPA_TDNN", "nOut": 16,
                                        **{k: list(v) if isinstance(v, tuple)
                                           else v
                                           for k, v in SMALL_ECAPA.items()}},
         "criterion": {"name": "AngularProto"}, "nClasses": 4}
    assert encoder_from_hparams(h, with_loss=True).gather_axis is None
    assert encoder_from_hparams(h, with_loss=True,
                                num_devices=2).gather_axis == "data"
    assert encoder_from_hparams({**h, "gather_metric_embeddings": False},
                                with_loss=True, num_devices=2
                                ).gather_axis is None


def test_cli_spawns_one_process_per_gpu(tmp_path, monkeypatch):
    """``--distributed`` with no process group configured and several
    GPUs visible starts one process per GPU with the same arguments."""
    import speakerverification_tpu_torch.cli.main as cli
    for k in ("SVTPU_COORDINATOR", "SVTPU_NUM_PROCESSES", "SVTPU_PROCESS_ID",
              "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    seen = []
    monkeypatch.setattr(cli, "spawn_ranks",
                        lambda argv, n, port: seen.append((argv, n, port))
                        or 0)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"save_folder: {tmp_path}/save\n")
    argv = ["--do_train", "--distributed", "--config", str(cfg)]
    assert cli.main(argv) == 0
    assert seen == [(argv, 3, None)]
