"""Rank programs of the port's multi-process CPU tests (no tests here).

``run_ranks(case, world, workdir)`` starts ``world`` processes of this
file, each joining a gloo process group through a ``FileStore`` under
``workdir`` (no TCP port, so test workers may run side by side), and
runs ``CASES[case](rank, world, workdir, inputs)``; the inputs come from
``workdir/inputs.pt`` and each rank's result goes to
``workdir/out_<rank>.pt``. The ranks import torch and the port only.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ----------------------------------------------------------------------
# the runner
# ----------------------------------------------------------------------
def run_ranks(case: str, world: int, workdir, inputs=None,
              timeout: float = 240.0) -> list:
    """Run ``case`` on ``world`` ranks; returns each rank's result. A
    rank that fails or outlives ``timeout`` fails the call (the others
    are killed)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(HERE)])}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), case, str(r), str(world),
         str(workdir)], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline:
                raise TimeoutError(f"{case}: ranks still running after "
                                   f"{timeout} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"{case}: ranks {bad} failed\n"
                           + "\n".join(f"--- rank {r}\n{logs[r][-4000:]}"
                                       for r, _ in bad))
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


def _join(rank: int, world: int, workdir: Path):
    from speakerverification_tpu_torch.parallel import (
        maybe_initialize_distributed,
    )
    torch.set_num_threads(1)
    ok = maybe_initialize_distributed({
        "coordinator_address": f"file://{workdir / 'store'}",
        "num_processes": world, "process_id": rank,
        "distributed_backend": "gloo", "device": "cpu"})
    assert ok == (world > 1)


# ----------------------------------------------------------------------
# models shared with the tests
# ----------------------------------------------------------------------
class BNFree(nn.Module):
    """The tests' BN-free backbone: a Dense on the features' mean over
    frames (the JAX tests' ``_BNFreeBackbone``)."""

    def __init__(self, n_in: int = 80, n_out: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(n_in, n_out)

    def forward(self, feats):
        return self.Dense_0(feats.mean(dim=1))


SMALL_ECAPA = dict(channels=(32, 32, 32, 32, 96), kernel_sizes=(5, 3, 3, 3, 1),
                   dilations=(1, 2, 3, 4, 1), attention_channels=8,
                   res2net_scale=4, se_channels=8)


def encoder(backbone: str, loss: str, n_out: int = 16, n_classes: int = 8,
            gather_axis=None):
    from speakerverification_tpu_torch.builder import build_model
    from speakerverification_tpu_torch.encoder import SpeakerEncoder
    from speakerverification_tpu_torch.losses import build_loss
    bb = (BNFree(80, n_out) if backbone == "bnfree"
          else build_model("ECAPA_TDNN", nOut=n_out, **SMALL_ECAPA))
    return SpeakerEncoder(backbone=bb, loss=build_loss(
        loss, nOut=n_out, nClasses=n_classes), gather_axis=gather_axis)


def state_from(model, tx, params, stats=None):
    """A port train state holding the given flax trees' weights."""
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    from speakerverification_tpu_torch.weights import params_from_jax
    state = create_train_state(model, tx, 0)
    model.load_state_dict(params_from_jax(params, stats, like=model))
    return state


def flax_trees(state):
    """``(params, batch_stats)`` in flax layout (the head's rows whole)."""
    from speakerverification_tpu_torch.training.checkpoint import (
        state_to_jax,
    )
    tree = state_to_jax(state)
    return tree["params"], tree["batch_stats"]


# ----------------------------------------------------------------------
# cases
# ----------------------------------------------------------------------
def case_dp(rank, world, workdir, inp):
    """Data-parallel steps (file test_torch_port_parallel.py)."""
    import torch.distributed as dist

    from speakerverification_tpu_torch.optim import build_optimizer
    from speakerverification_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
        process_allgather,
        replicate_state,
        shard_batch,
    )
    from speakerverification_tpu_torch.parallel.collectives import fold_in
    out = {}
    mesh = make_mesh()
    for name in ("bnfree", "bn", "metric"):
        c = inp[name]
        model = encoder(c["backbone"], c["loss"], n_classes=c["classes"],
                        gather_axis="data" if name == "metric" else None)
        tx = build_optimizer(c["opt"], learning_rate=c["lr"])
        state = state_from(model, tx, c["params"], c.get("stats"))
        step = make_dp_train_step(model, tx, mesh)
        b = shard_batch({"wave": c["wave"], "label": c["label"]}, mesh)
        stats_before = {k: v.clone() for k, v in state.batch_stats.items()}
        state, m = step(state, b["wave"], b["label"], c["lr"],
                        torch.Generator().manual_seed(9))
        params, stats = flax_trees(state)
        out[name] = {"loss": float(m["loss"]), "prec1": float(m["prec1"]),
                     "params": params, "stats": stats,
                     "stats_before": stats_before}
    # the generator folded with the data rank
    g = fold_in(torch.Generator().manual_seed(5), mesh.get_local_rank("data"))
    out["draw"] = torch.rand(4, generator=g)
    # rank 1's weights perturbed, then rank 0's broadcast
    model = encoder("bnfree", "AAmSoftmax")
    tx = build_optimizer("adam", learning_rate=1e-3)
    state = state_from(model, tx, inp["bnfree"]["params"])
    with torch.no_grad():
        for p in state.params.values():
            p.add_(float(rank))
    replicate_state(state, mesh)
    out["replicated"] = {k: v.detach().clone()
                         for k, v in state.params.items()}
    out["allgather"] = process_allgather(np.full((2, 3), rank, np.float32))
    try:
        make_mesh(("data",), shape=[3])
    except ValueError as exc:
        out["mesh_error"] = str(exc)
    # distributed extraction: every rank gets every file, in order
    from speakerverification_tpu_torch.evaluation.evaluator import (
        extract_embeddings,
    )

    def embed_fn(w):
        w = torch.as_tensor(w)
        return torch.stack([w.mean(-1), w.std(-1), w[:, :5].sum(-1)], -1)
    emb = extract_embeddings(embed_fn, inp["files"], inp["audio_spec"],
                             num_eval=2, batch_size=2, num_workers=1,
                             distributed=True)
    out["extract"] = emb.numpy()
    out["world"] = dist.get_world_size()
    return out


def case_tp(rank, world, workdir, inp):
    """Data 2 x model 2 steps (file test_torch_port_parallel_tp.py)."""
    from speakerverification_tpu_torch.optim import build_optimizer
    from speakerverification_tpu_torch.parallel import (
        make_dp_tp_train_step,
        make_mesh,
        shard_batch,
        shard_state_tp,
        tp_state_specs,
    )
    from speakerverification_tpu_torch.training import checkpoint as tckpt
    out = {}
    mesh = make_mesh(("data", "model"), (2, 2))
    c = inp["tp"]
    wave, label = c["wave"], c["label"]
    for name, opt, steps in (("sgd", ("sgd", {"momentum": 0.0}), 1),
                             ("adam", ("adam", {}), 3)):
        model = encoder("bnfree", "ShardedAAmSoftmax", n_out=c["n_out"],
                        n_classes=c["classes"])
        tx = build_optimizer(opt[0], learning_rate=c["lr_" + name], **opt[1])
        state = state_from(model, tx, c["params"])
        specs = tp_state_specs(state, "model", 2)
        state = shard_state_tp(state, mesh)
        step = make_dp_tp_train_step(model, tx, mesh, state)
        b = shard_batch({"wave": wave, "label": label}, mesh)
        losses = []
        for _ in range(steps):
            state, m = step(state, b["wave"], b["label"], c["lr_" + name],
                            torch.Generator().manual_seed(1))
            losses.append(float(m["loss"]))
        params, _ = flax_trees(state)
        out[name] = {"loss": losses, "prec1": float(m["prec1"]),
                     "params": params,
                     "head_rows": tuple(model.loss.weight.shape),
                     "sharded": sorted(p for p, s in specs.items() if s)}
        if name == "adam":
            # the msgpack path gathers the head's rows: every rank calls it
            tree = tckpt.state_to_jax(state)
            if rank == 0:
                from speakerverification_tpu_torch import checkpoint as codec
                codec.save_checkpoint(workdir / "tp.msgpack", tree)
            out["backbone"] = {k: v.detach().clone()
                               for k, v in state.params.items()
                               if k.startswith("backbone.")}
    # the two refusals
    for what, loss, classes in (("aware", "AAmSoftmax", c["classes"]),
                                ("divisible", "ShardedAAmSoftmax", 15)):
        model = encoder("bnfree", loss, n_out=c["n_out"], n_classes=classes)
        tx = build_optimizer("adam", learning_rate=1e-2)
        state = state_from(model, tx, c["params"] if classes == c["classes"]
                           else c["params15"])
        try:
            make_dp_tp_train_step(model, tx, mesh, state)
        except ValueError as exc:
            out["refused_" + what] = str(exc)
    return out


def _tp_state(c, mesh, opt="adam"):
    from speakerverification_tpu_torch.optim import build_optimizer
    from speakerverification_tpu_torch.parallel import shard_state_tp
    model = encoder("bnfree", "ShardedAAmSoftmax", n_out=c["n_out"],
                    n_classes=c["classes"])
    tx = build_optimizer(opt, learning_rate=1e-2)
    state = state_from(model, tx, c["params"])
    return shard_state_tp(state, mesh), model, tx


def case_ckpt(rank, world, workdir, inp):
    """Sharded checkpoints (file test_torch_port_parallel_ckpt.py)."""
    from speakerverification_tpu_torch.parallel import (
        make_dp_tp_train_step,
        make_mesh,
        shard_batch,
    )
    from speakerverification_tpu_torch.parallel.tp import state_leaves
    from speakerverification_tpu_torch.training import checkpoint_sharded as cs
    from speakerverification_tpu_torch.training.checkpoint import (
        CheckpointManager,
        load_checkpoint,
        state_to_jax,
    )
    c = inp["ckpt"]
    root = Path(inp["root"])
    out = {}
    # data 1 x model 4: one step, then the sharded save
    mesh4 = make_mesh(("data", "model"), (1, 4))
    state, model, tx = _tp_state(c, mesh4)
    step = make_dp_tp_train_step(model, tx, mesh4, state)
    b = shard_batch({"wave": c["wave"], "label": c["label"]}, mesh4)
    state, _ = step(state, b["wave"], b["label"], 1e-2, None)
    cs.save_sharded(root / "m4", state, meta={"epoch": 1})
    tree = state_to_jax(state)              # the gathered whole, for checks
    if rank == 0:
        torch.save(tree, root / "m4_whole.pt")
    out["m4_local"] = {p: t.detach().clone() for p, t in state_leaves(state)}
    # read back into the same layout
    fresh, _, _ = _tp_state(c, mesh4)
    load_checkpoint(root / "m4", fresh)
    out["m4_back"] = {p: t.detach().clone() for p, t in state_leaves(fresh)}
    out["m4_step"] = fresh.step
    # async: the snapshot is what was saved, whatever the step does next
    cs.async_save_sharded(root / "async", state, meta={"epoch": 2})
    snap = {p: t.detach().clone() for p, t in state_leaves(state)}
    state, _ = step(state, b["wave"], b["label"], 1e-2, None)
    cs.wait(root / "async")
    again, _, _ = _tp_state(c, mesh4)
    cs.restore_sharded(root / "async", again)
    out["async_snap"] = snap
    out["async_back"] = {p: t.detach().clone()
                         for p, t in state_leaves(again)}
    # resharded: data 2 x model 2 reads the 4-way checkpoint
    mesh22 = make_mesh(("data", "model"), (2, 2))
    two, _, _ = _tp_state(c, mesh22)
    cs.restore_sharded(root / "m4", two)
    out["m22"] = {p: t.detach().clone() for p, t in state_leaves(two)}
    out["m22_rows"] = {p: v[:3] for p, v in two.shards.items()}
    # retention with the sharded backend, every rank calling the manager
    mgr = CheckpointManager(root / "run", top_k=2, backend="sharded")
    for epoch, loss in enumerate((3.0, 2.0, 2.5, 1.0), start=1):
        mgr.save_epoch(state, epoch, loss, 1e-2)
    out["latest"] = str(mgr.latest())
    return out


CASES = {"dp": case_dp, "tp": case_tp, "ckpt": case_ckpt}


def main() -> None:
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    try:
        _join(rank, world, workdir)
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        result = CASES[case](rank, world, workdir, inputs)
        torch.save(result, workdir / f"out_{rank}.pt")
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


if __name__ == "__main__":
    main()
