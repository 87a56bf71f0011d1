"""Sharded checkpoints of the port (``training/checkpoint_sharded.py``,
on ``torch.distributed.checkpoint``): a state whose head is split over a
data 1 x model 4 layout of 4 gloo ranks is saved, read back, saved
asynchronously, read into a data 2 x model 2 layout and into one
process, and kept by ``CheckpointManager(backend="sharded")``. One
group runs every case once (``_torch_port_parallel_workers.case_ckpt``).

A directory marked as the JAX package's orbax store that is not one
(no tree metadata) is refused, naming orbax; real ones are read by
``training/orbax_read.py`` (``tests/test_torch_port_orbax.py``).
"""

import json
import time

import numpy as np
import pytest
import torch

from speakerverification_tpu_torch import checkpoint as codec
from speakerverification_tpu_torch import inference as tinference
from speakerverification_tpu_torch.optim import build_optimizer
from speakerverification_tpu_torch.parallel.tp import state_leaves
from speakerverification_tpu_torch.training import checkpoint as tckpt
from speakerverification_tpu_torch.training import checkpoint_sharded as cs
from speakerverification_tpu_torch.training.state import create_train_state
from speakerverification_tpu_torch.weights import params_to_jax

from _torch_port_parallel_workers import encoder, run_ranks, state_from

N_CLASSES, N_OUT = 16, 8


def _params():
    model = encoder("bnfree", "AAmSoftmax", n_out=N_OUT, n_classes=N_CLASSES)
    from speakerverification_tpu_torch.weights import init_weights_
    init_weights_(model, torch.Generator().manual_seed(4))
    return params_to_jax(model.state_dict())[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(2)
    c = {"n_out": N_OUT, "classes": N_CLASSES, "params": _params(),
         "wave": rng.normal(0, 0.1, (4, 2, 4000)).astype(np.float32),
         "label": np.array([1, 6, 11, 15], np.int64)}
    ranks = run_ranks("ckpt", 4, tmp / "work",
                      {"ckpt": c, "root": str(tmp)})
    return {"root": tmp, "ranks": ranks, "inputs": c}


def _whole_state(c):
    """A one-process state of the tests' model, to read into."""
    model = encoder("bnfree", "ShardedAAmSoftmax", n_out=N_OUT,
                    n_classes=N_CLASSES)
    return state_from(model, build_optimizer("adam", learning_rate=1e-2),
                      c["params"])


def test_sharded_round_trip_restores_each_ranks_state(run):
    for r in run["ranks"]:
        assert set(r["m4_back"]) == set(r["m4_local"])
        for p, t in r["m4_local"].items():
            assert torch.equal(r["m4_back"][p], t), p
        assert r["m4_step"] == 1


def test_async_save_is_the_snapshot_once_waited_for(run):
    for r in run["ranks"]:
        for p, t in r["async_snap"].items():
            assert torch.equal(r["async_back"][p], t), p
    root = run["root"]
    assert cs.is_sharded_checkpoint(root / "async")
    assert json.loads((root / "async.json").read_text()) == {"epoch": 2}
    assert not list(root.glob(".*tmp*"))          # swapped, nothing left


def test_restore_reshards_to_another_layout(run):
    """The 4-way checkpoint read by a data 2 x model 2 layout: each rank
    gets its half of the head's rows (and of Adam's moments)."""
    whole = torch.load(run["root"] / "m4_whole.pt", weights_only=False)
    w = whole["params"]["loss"]["weight"]
    for rank, r in enumerate(run["ranks"]):
        lo, hi, rows = r["m22_rows"]["params/loss.weight"]
        assert (lo, hi, rows) == ((rank % 2) * 8, (rank % 2 + 1) * 8, 16)
        np.testing.assert_array_equal(
            r["m22"]["params/loss.weight"].numpy(), w[lo:hi])
        for p, t in r["m22"].items():
            if "loss.weight" not in p:
                assert torch.equal(t, run["ranks"][0]["m4_local"][p]), p


def test_restore_into_one_process_equals_the_gathered_state(run):
    """No process group: the blocks of all four ranks assemble the whole
    state, bit for bit the state the ranks gathered."""
    state = _whole_state(run["inputs"])
    tckpt.load_checkpoint(run["root"] / "m4", state)
    got = tckpt.state_to_jax(state)
    whole = torch.load(run["root"] / "m4_whole.pt", weights_only=False)
    from flax.traverse_util import flatten_dict
    for key in ("params", "batch_stats"):
        a, b = flatten_dict(got[key]), flatten_dict(whole[key])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert state.step == 1
    # the assembled msgpack tree of the directory is the same state
    raw = codec.load_checkpoint(run["root"] / "m4")
    np.testing.assert_array_equal(raw["params"]["loss"]["weight"],
                                  whole["params"]["loss"]["weight"])


def test_each_rank_writes_only_its_rows(run):
    """The store's entries: one per replicated leaf and one per row block
    of a sharded leaf, each block in the file of the rank that held it;
    the marker names the blocks."""
    from torch.distributed.checkpoint import FileSystemReader
    md = FileSystemReader(str(run["root"] / "m4")).read_metadata()
    blocks = {k for k in md.state_dict_metadata
              if k.startswith("params/loss.weight@")}
    assert blocks == {f"params/loss.weight@rows={4 * i}:{4 * i + 4}"
                      for i in range(4)}
    files = {md.storage_data[idx].relative_path
             for idx in md.storage_data if idx.fqn in blocks}
    assert len(files) == 4
    marker = json.loads((run["root"] / "m4" / cs.MARKER).read_text())
    assert marker["leaves"]["params/loss.weight"]["blocks"] == [
        [0, 4], [4, 8], [8, 12], [12, 16]]
    assert marker["leaves"]["params/backbone.Dense_0.weight"]["blocks"] \
        is None


def test_manager_keeps_sharded_retention(run):
    mdir = run["root"] / "run"
    names = sorted(p.name for p in mdir.iterdir())
    assert "best_state" in names and "best_state_top1" in names
    assert "best_state_top2" in names and "last_state" in names
    assert "best_state.json" in names
    assert all(cs.is_sharded_checkpoint(mdir / n) for n in
               ("best_state", "best_state_top1", "best_state_top2",
                "last_state"))
    assert json.loads((mdir / "best_state.json").read_text())["loss"] == 1.0
    assert json.loads((mdir / "best_state_top2.json").read_text())[
        "loss"] == 2.0
    assert json.loads((mdir / "model_state_log.json").read_text())[
        "epoch"] == 4
    for r in run["ranks"]:
        assert r["latest"] == str(mdir / "last_state")


def test_load_params_only_reads_a_sharded_directory(run):
    state = _whole_state(run["inputs"])
    params, stats = params_to_jax(state.model.state_dict())
    got = codec.load_params_only(run["root"] / "m4",
                                 {"params": params, "batch_stats": stats})
    whole = torch.load(run["root"] / "m4_whole.pt", weights_only=False)
    np.testing.assert_array_equal(got["params"]["loss"]["weight"],
                                  whole["params"]["loss"]["weight"])


def test_orbax_directories_are_still_refused_by_name(tmp_path):
    d = tmp_path / "best_state"
    d.mkdir()
    (d / "manifest.ocdbt").write_text("")
    (d / "_METADATA").write_text("{}")
    assert cs.is_orbax_checkpoint(d) and not cs.is_sharded_checkpoint(d)
    with pytest.raises(ValueError, match="orbax"):
        codec.load_checkpoint(d)
    other = tmp_path / "other"
    other.mkdir()
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        codec.load_checkpoint(other)


def _small_state():
    model = encoder("bnfree", "AAmSoftmax", n_out=N_OUT, n_classes=N_CLASSES)
    return create_train_state(model, build_optimizer("adam",
                                                     learning_rate=1e-2), 0)


def test_one_process_save_and_select_weights(tmp_path):
    """Without a process group: the save, the engine's choice of a
    sharded best_state, and the overwrite leaving no temporary."""
    state = _small_state()
    mdir = tmp_path / "model"
    cs.save_sharded(mdir / "best_state", state, meta={"loss": 1.0})
    cs.save_sharded(mdir / "best_state", state, meta={"loss": 0.5})
    assert sorted(p.name for p in mdir.iterdir()) == ["best_state",
                                                      "best_state.json"]
    assert tinference._select_weights({}, mdir) == mdir / "best_state"
    back = _small_state()
    with torch.no_grad():
        for p in back.params.values():
            p.zero_()
    tckpt.load_checkpoint(mdir / "best_state", back)
    for (p, a), (_, b) in zip(state_leaves(state), state_leaves(back)):
        assert torch.equal(a, b), p


def test_backend_toggle_resumes_from_the_newest(tmp_path):
    state = _small_state()
    m1 = tckpt.CheckpointManager(tmp_path, backend="msgpack")
    m1.save_epoch(state, 1, 2.0, 1e-3)
    time.sleep(0.05)
    m2 = tckpt.CheckpointManager(tmp_path, backend="sharded")
    assert m2._best_loss == 2.0
    m2.save_epoch(state, 2, 1.0, 1e-3)
    assert m2.latest() == tmp_path / "last_state"
    assert m2.best() == tmp_path / "best_state"
    m3 = tckpt.CheckpointManager(tmp_path, backend="msgpack")
    assert m3.latest() == tmp_path / "last_state"
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        tckpt.CheckpointManager(tmp_path, backend="orbax")


def test_restore_refuses_another_optimizer_state(tmp_path):
    state = _small_state()
    cs.save_sharded(tmp_path / "s", state)
    model = encoder("bnfree", "AAmSoftmax", n_out=N_OUT, n_classes=N_CLASSES)
    other = create_train_state(model, build_optimizer("sgd",
                                                      learning_rate=1e-2), 0)
    with pytest.raises(ValueError, match="optimizer state does not match"):
        cs.restore_sharded(tmp_path / "s", other)
