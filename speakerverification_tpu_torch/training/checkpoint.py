"""Train-state checkpoints and their retention (port of
``training/checkpoint.py``: ``CheckpointManager``, ``load_checkpoint``,
``load_params_only``).

A :class:`~speakerverification_tpu_torch.training.state.TrainState` is
written as the JAX trainer writes its ``TrainState``: flax msgpack
(``checkpoint.save_checkpoint``, the port's codec) of ``{"step",
"params", "batch_stats", "opt_state"}`` in flax layout
(``weights.params_to_jax``; the loss head under ``params["loss"]``), the
optimizer state as optax's serializes (``optim``: moments and EMA in
flax layout, counts int32, the learning rate fp32, flags bool; a
``LeafTree``'s leaves, already in flax layout, at each parameter's flax
path, a tuple of them with index keys), beside a JSON sidecar. The JAX
package's ``load_checkpoint`` restores such a file as its full train
state, and the port restores the JAX package's. A state whose head is
class-sharded (``TrainState.shards``) is written whole: the ranks gather
its row blocks first, so the file keeps the JAX layout.

``CheckpointManager(backend="sharded")`` keeps every checkpoint as a
sharded directory instead (``training/checkpoint_sharded.py``: each rank
writes its own rows), named like the msgpack files without the suffix;
``load_checkpoint`` reads either. Under ``torch.distributed`` every rank
calls the manager: rank 0 alone writes msgpack files, moves and deletes,
and every rank writes its part of a sharded checkpoint.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from speakerverification_tpu_torch import checkpoint as codec
from speakerverification_tpu_torch.optim import LeafTree, ParamTree
from speakerverification_tpu_torch.training.checkpoint_sharded import (
    ckpt_group,
    is_sharded_checkpoint,
    restore_sharded,
    save_sharded,
)
from speakerverification_tpu_torch.training.state import TrainState
from speakerverification_tpu_torch.weights import (
    flax_path,
    params_from_jax,
    params_to_jax,
)

__all__ = ["state_to_jax", "load_checkpoint", "load_params_only",
           "CheckpointManager"]


def _leaf_path(key: str, model_state: dict) -> tuple:
    """The flax path of the parameter ``key`` of the model."""
    return flax_path(key, model_state[key].dim())


def _opt_to_jax(node: Any, model_state: dict) -> Any:
    if isinstance(node, ParamTree):
        # the model's state supplies the BatchNorm scopes; the tree's
        # tensors replace its parameters
        return params_to_jax({**model_state, **node})[0]
    if isinstance(node, LeafTree):
        out: dict = {}
        for key, v in node.items():
            *scopes, name = _leaf_path(key, model_state)
            d = out
            for s in scopes:
                d = d.setdefault(s, {})
            d[name] = _opt_to_jax(v, model_state)
        return out
    if isinstance(node, dict):
        return {k: _opt_to_jax(v, model_state) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_opt_to_jax(v, model_state) for v in node)
    if isinstance(node, bool):
        return np.asarray(node, np.bool_)
    if isinstance(node, int):
        return np.asarray(node, np.int32)
    if isinstance(node, (float, np.floating)):
        return np.asarray(node, np.float32)
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    return node


def state_to_jax(state: TrainState) -> dict:
    """The state as the JAX ``TrainState`` serializes: numpy trees in
    flax layout. The row blocks of a class-sharded head are gathered
    first (a collective over its group: every rank calls it)."""
    sd = state.model.state_dict()
    opt_state = state.opt_state
    if state.shards:
        from speakerverification_tpu_torch.parallel.tp import (
            full_leaves,
            map_leaves,
        )
        full = full_leaves(state)
        sd = {**sd, **{p[len("params/"):]: t for p, t in full.items()
                       if p.startswith("params/")}}
        opt_state = map_leaves(opt_state, lambda p, t: full.get(p, t))
    params, stats = params_to_jax(sd)
    return {"step": np.asarray(state.step, np.int32), "params": params,
            "batch_stats": stats,
            "opt_state": _opt_to_jax(opt_state, sd)}


def _mismatch(path: str, what: str) -> ValueError:
    return ValueError(f"checkpoint optimizer state does not match the "
                      f"optimizer's at {path or '<root>'}: {what}")


def _n_leaves(tree: Any) -> int:
    return (sum(_n_leaves(v) for v in tree.values())
            if isinstance(tree, dict) else 1)


def _opt_from_jax(template: Any, raw: Any, stats: dict, path: str = "",
                  model_state: Optional[dict] = None) -> Any:
    """``raw`` (a flax state dict) restored into ``template``'s structure;
    ``ValueError`` where the two differ. ``model_state`` (the model's
    ``state_dict``) places a ``LeafTree``'s leaves."""
    if isinstance(template, LeafTree):
        out = LeafTree()
        n = 0
        for key, t in template.items():
            node = raw
            for s in _leaf_path(key, model_state):
                if not isinstance(node, dict) or s not in node:
                    raise _mismatch(f"{path}/{key}", "missing")
                node = node[s]
            out[key] = _opt_from_jax(t, node, stats, f"{path}/{key}",
                                     model_state)
            n += _n_leaves(node)
        if not isinstance(raw, dict) or _n_leaves(raw) != n:
            raise _mismatch(path, "leaves left over")
        return out
    if isinstance(template, torch.Tensor):
        arr = np.asarray(raw)
        if tuple(arr.shape) != tuple(template.shape):
            raise _mismatch(path, f"shape {arr.shape} != "
                            f"{tuple(template.shape)}")
        return torch.from_numpy(np.array(arr)).to(template.device,
                                                  template.dtype)
    if isinstance(template, ParamTree):
        if not isinstance(raw, dict):
            raise _mismatch(path, "expected a parameter tree")
        try:
            sd = params_from_jax(raw, stats)
        except KeyError as exc:
            raise _mismatch(path, str(exc)) from None
        out = ParamTree()
        for k, t in template.items():
            if k not in sd or tuple(sd[k].shape) != tuple(t.shape):
                raise _mismatch(f"{path}/{k}", "missing or of another shape")
            out[k] = sd[k].to(t.device, t.dtype)
        extra = sorted(set(_param_keys(sd)) - set(template))
        if extra:
            raise _mismatch(path, f"left over {extra[:3]}")
        return out
    if isinstance(template, (dict, tuple)):
        keys = (list(template) if isinstance(template, dict)
                else [str(i) for i in range(len(template))])
        if not isinstance(raw, dict) or set(raw) != set(keys):
            got = sorted(raw) if isinstance(raw, dict) else type(raw)
            raise _mismatch(path, f"keys {got} != {keys}")
        vals = template.values() if isinstance(template, dict) else template
        out = [_opt_from_jax(t, raw[k], stats, f"{path}/{k}", model_state)
               for k, t in zip(keys, vals)]
        return dict(zip(keys, out)) if isinstance(template, dict) \
            else tuple(out)
    if isinstance(template, bool):
        return bool(raw)
    if isinstance(template, int):
        return int(np.asarray(raw))
    if isinstance(template, (float, np.floating)):
        return np.float32(np.asarray(raw))
    return raw


def _param_keys(sd: dict) -> list:
    return [k for k in sd if k.rpartition(".")[2] not in
            ("running_mean", "running_var", "num_batches_tracked")]


def load_checkpoint(path: str | Path, state: TrainState) -> TrainState:
    """Restore a whole train state (weights, statistics, optimizer state,
    step) into ``state``. Raises ``ValueError`` when the checkpoint's
    optimizer state or weights do not match ``state``'s (the trainer then
    restores the weights only). A sharded directory is read into
    ``state``'s own layout (``checkpoint_sharded.restore_sharded``)."""
    if is_sharded_checkpoint(path):
        return restore_sharded(path, state)
    raw = codec.load_checkpoint(path)
    for key in ("params", "batch_stats", "opt_state"):
        if key not in raw:
            raise ValueError(f"{path}: not a train state (no {key!r})")
    try:
        sd = params_from_jax(raw["params"], raw["batch_stats"],
                             like=state.model)
    except KeyError as exc:
        raise ValueError(f"{path}: {exc}") from None
    opt_state = _opt_from_jax(state.opt_state, raw["opt_state"],
                              raw["batch_stats"],
                              model_state=state.model.state_dict())
    state.model.load_state_dict(sd)
    state.opt_state = opt_state
    state.step = int(np.asarray(raw.get("step", 0)))
    return state


def load_params_only(path: str | Path, state: TrainState) -> TrainState:
    """Merge the checkpoint's weights and batch statistics into
    ``state``'s model, with ``checkpoint.load_params_only``'s tolerance;
    the optimizer state and step stay."""
    params, stats = params_to_jax(state.model.state_dict())
    merged = codec.load_params_only(path, {"params": params,
                                           "batch_stats": stats})
    state.model.load_state_dict(params_from_jax(
        merged["params"], merged["batch_stats"], like=state.model))
    return state


class CheckpointManager:
    """best/top-k/last retention with a resume log, in ``run_dir``:
    ``best_state.msgpack``, ``best_state_top{1..k}.msgpack``,
    ``last_state.msgpack`` (or per-epoch ``model_state_{e:06d}``),
    time-based ``ckpt_YYYYmmdd_HH_MM`` (keep 3) and
    ``model_state_log.json``."""

    SUFFIX = ".msgpack"

    def __init__(self, run_dir: str | Path, top_k: int = 3,
                 save_per_epoch: bool = False,
                 time_interval_min: float = -1, backend: str = "msgpack"):
        if backend not in ("msgpack", "sharded"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.backend = backend
        # sharded checkpoints are directories named like the msgpack
        # files minus the suffix; the retention below is path-based
        self.SUFFIX = ".msgpack" if backend == "msgpack" else ""
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.save_per_epoch = save_per_epoch
        self.time_interval_min = time_interval_min
        self._last_time_save = time.time()
        self._log_path = self.run_dir / "model_state_log.json"
        # the best loss of an earlier run, from its best_state sidecar, so
        # that a resumed run's first epoch cannot clobber best_state
        self._best_loss = float("inf")
        best = self._existing("best_state")
        best_side = Path(str(best) + ".json") if best else None
        if best_side and best_side.exists():
            try:
                self._best_loss = float(json.loads(
                    best_side.read_text()).get("loss", float("inf")))
            except (ValueError, json.JSONDecodeError, TypeError):
                pass

    def _p(self, name: str) -> Path:
        return self.run_dir / (name + self.SUFFIX)

    def _existing(self, name: str) -> Optional[Path]:
        """The newer of ``name.msgpack`` and a directory ``name`` (the
        port's sharded format or a JAX orbax directory; both load)."""
        cands = [p for p in (self.run_dir / (name + ".msgpack"),
                             self.run_dir / name) if p.exists()]
        if not cands:
            return None
        return max(cands, key=lambda p: p.stat().st_mtime)

    def _save(self, path: Path, state: TrainState, meta: dict) -> None:
        if self.backend == "sharded":
            save_sharded(path, state, meta)     # every rank writes its part
        elif self.writer:
            codec.save_checkpoint(path, state_to_jax(state), meta)
        elif state.shards:
            state_to_jax(state)     # the gather of the head's row blocks

    @staticmethod
    def _drop(path: Path) -> None:
        if path.is_dir():
            shutil.rmtree(path)
        else:
            path.unlink(missing_ok=True)

    @staticmethod
    def _move(src: Path, dst: Path) -> None:
        """``src.replace(dst)``, also for directories."""
        if dst.is_dir():
            shutil.rmtree(dst)
        src.replace(dst)

    def _glob(self, pattern: str) -> list[Path]:
        hits = sorted(self.run_dir.glob(pattern + self.SUFFIX))
        if self.backend == "sharded":
            hits = [h for h in hits if h.is_dir()]   # not the sidecars
        return hits

    @staticmethod
    def _agree(flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a time-based save is a
        collective: every rank must take it or none)."""
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return flag
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=ckpt_group())
        return bool(t.item())

    def save_epoch(self, state: TrainState, epoch: int, loss: float,
                   lr: float, extra_meta: Optional[dict] = None) -> dict:
        """Apply the retention policy for one finished epoch."""
        meta = {"epoch": epoch, "step": int(state.step), "loss": float(loss),
                "lr": float(lr), **(extra_meta or {})}
        saved = {"best": False}
        if loss < self._best_loss:
            self._best_loss = loss
            # rotate top-k: top1 -> top2 -> ... -> topk (dropped)
            for i in range(self.top_k, 1, -1):
                src = self._p(f"best_state_top{i - 1}")
                if self.writer and src.exists():
                    self._move(src, self._p(f"best_state_top{i}"))
                    js = Path(str(src) + ".json")
                    if js.exists():
                        js.replace(Path(str(self._p(f"best_state_top{i}"))
                                        + ".json"))
            self._save(self._p("best_state_top1"), state, meta)
            self._save(self._p("best_state"), state, meta)
            saved["best"] = True

        if self.save_per_epoch:
            self._save(self._p(f"model_state_{epoch:06d}"), state, meta)
            # a last_state here is a stale preemption snapshot
            for stale in (self.run_dir / "last_state.msgpack",
                          self.run_dir / "last_state"):
                if self.writer and stale.exists():
                    self._drop(stale)
                    Path(str(stale) + ".json").unlink(missing_ok=True)
        else:
            self._save(self._p("last_state"), state, meta)

        if self._agree(self.time_interval_min > 0
                       and time.time() - self._last_time_save
                       > self.time_interval_min * 60):
            self._save(self._p(time.strftime("ckpt_%Y%m%d_%H_%M")), state,
                       meta)
            self._last_time_save = time.time()
            for old in self._glob("ckpt_*")[:-3] if self.writer else ():
                self._drop(old)
                Path(str(old) + ".json").unlink(missing_ok=True)

        if self.writer:
            self._log_path.write_text(json.dumps(meta))
        return saved

    def save_interrupt(self, state: TrainState, epoch_unfinished: int,
                       lr: float, best_loss: float) -> None:
        """Preemption snapshot: last_state with the interrupted epoch
        marked unfinished, so that a resume runs it again; best/top-k
        stay."""
        meta = {"epoch": epoch_unfinished - 1, "step": int(state.step),
                "lr": float(lr), "preempted": True}
        if best_loss == best_loss and best_loss != float("inf"):
            meta["loss"] = float(best_loss)
        self._save(self._p("last_state"), state, meta)
        if self.writer:
            self._log_path.write_text(json.dumps(meta))

    def latest(self) -> Optional[Path]:
        """Resume priority: last_state > newest per-epoch > best."""
        last = self._existing("last_state")
        if last is not None:
            return last
        epochs = sorted(
            set(self.run_dir.glob("model_state_*.msgpack"))
            | {p for p in self.run_dir.glob("model_state_*") if p.is_dir()},
            key=lambda p: (p.name.removesuffix(".msgpack"),
                           p.stat().st_mtime))
        if epochs:
            return epochs[-1]
        return self._existing("best_state")

    def best(self) -> Optional[Path]:
        return self._existing("best_state")

    def resume_meta(self) -> dict:
        return (json.loads(self._log_path.read_text())
                if self._log_path.exists() else {})
