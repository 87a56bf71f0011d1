"""Sharded train-state checkpoints: no gather, optional async (port of
``training/checkpoint_sharded.py``, on ``torch.distributed.checkpoint``).

The msgpack path (``training/checkpoint.py``) writes the whole state
from one rank, gathering the class-sharded head first. A sharded
checkpoint keeps rows where they live: each rank writes only what it
holds and nobody gathers anything.

* The directory is a ``torch.distributed.checkpoint`` store (``.metadata``
  and ``__<rank>_0.distcp`` files) plus ``svtorch_sharded.json``, the
  marker that tells it from the JAX package's orbax directories (which
  the port reads through ``training/orbax_read.py``): the step, each
  leaf's shape, dtype and row blocks, and the optimizer state's
  structure with its scalars.
* Replicated leaves are written once, by rank 0; a row-sharded leaf
  (``TrainState.shards``) as one entry per row block,
  ``<path>@rows=<lo>:<hi>``, by the ranks of the first data row.
* :func:`save_sharded` writes into a hidden sibling and swaps it into
  place only when every rank's bytes are durable, so the previous
  checkpoint survives a crash mid-write; the JSON sidecar ``meta``
  (the msgpack path's) is written by rank 0.
* :func:`async_save_sharded` returns once the tensors are copied to host
  memory; a thread writes them over a process group of its own (gloo),
  so the step's collectives never interleave with the checkpoint's;
  :func:`wait` (every rank calls it) makes the save durable and swaps it.
* :func:`restore_sharded` reads into ``target``'s layout, which may be
  another world size: each leaf's rows are cut from the blocks that
  overlap them. :func:`raw_tree` reads the whole state as the JAX
  package's msgpack tree, which the loaders of ``checkpoint.py`` take.

Every rank of the process group calls :func:`save_sharded`; without a
process group it is a one-process save.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save_sharded", "async_save_sharded", "restore_sharded", "wait",
           "is_sharded_checkpoint", "is_orbax_checkpoint", "raw_tree",
           "ckpt_group", "MARKER"]

MARKER = "svtorch_sharded.json"
FORMAT = "speakerverification_tpu_torch sharded train state"
_ASYNC: dict = {}          # final path -> (thread, tmp, marker, meta, errors)
_GROUPS: dict = {}         # id of the default group -> (it, a gloo group)


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def ckpt_group():
    """A gloo group over every rank, made once (collectively), for the
    checkpoint's own collectives."""
    world = dist.group.WORLD
    entry = _GROUPS.get(id(world))
    if entry is None or entry[0] is not world:
        entry = _GROUPS[id(world)] = (world, dist.new_group(backend="gloo"))
    return entry[1]


def _barrier() -> None:
    if _distributed():
        dist.barrier(group=ckpt_group())


def is_orbax_checkpoint(path: str | Path) -> bool:
    """True for the JAX package's orbax directories (by their marker
    files), which ``training/orbax_read.py`` reads."""
    p = Path(path)
    return p.is_dir() and ((p / "_CHECKPOINT_METADATA").exists()
                           or (p / "manifest.ocdbt").exists()
                           or (p / "_METADATA").exists()
                           or any(p.glob("*.orbax-checkpoint*")))


def is_sharded_checkpoint(path: str | Path) -> bool:
    """True when ``path`` is the port's sharded checkpoint directory."""
    if str(Path(path)) in _ASYNC:          # finalize a pending async save
        wait(path)
    p = Path(path)
    return p.is_dir() and (p / MARKER).exists()


# ----------------------------------------------------------------------
# the state as entries
# ----------------------------------------------------------------------
def _scalar(v):
    if isinstance(v, bool):
        return {"v": v, "type": "bool"}
    if isinstance(v, int):
        return {"v": v, "type": "int"}
    if isinstance(v, (float, np.floating)):
        return {"v": float(v), "type": type(v).__name__}
    raise TypeError(f"cannot store {type(v).__name__} in a sharded "
                    "checkpoint")


def _structure(node, path: str):
    """The optimizer state's tree with tensors as ``{"t": path}`` and
    scalars as ``{"v": value, "type": ...}``."""
    if isinstance(node, dict):
        return {"dict": type(node).__name__,
                "items": [[k, _structure(v, f"{path}/{k}")]
                          for k, v in node.items()]}
    if isinstance(node, tuple):
        return {"tuple": [_structure(v, f"{path}/{i}")
                          for i, v in enumerate(node)]}
    if isinstance(node, torch.Tensor):
        return {"t": path}
    return _scalar(node)


def _block_key(path: str, lo: int, hi: int) -> str:
    return f"{path}@rows={lo}:{hi}"


def _entries(state) -> tuple[dict, dict]:
    """``(this rank's entries, leaf table)``: host copies of what this
    rank writes, and every leaf's shape, dtype and blocks."""
    from speakerverification_tpu_torch.parallel.tp import state_leaves
    rank = _rank()
    table, mine = {}, {}
    for path, t in state_leaves(state):
        t = t.detach()
        if path in state.shards:
            lo, hi, rows, group = state.shards[path]
            n = dist.get_world_size(group)
            step = hi - lo
            table[path] = {"shape": [rows, *t.shape[1:]],
                           "dtype": str(t.dtype).removeprefix("torch."),
                           "blocks": [[i * step, (i + 1) * step]
                                      for i in range(n)]}
            # the model group of rank 0 (the first data row) writes
            if 0 in dist.get_process_group_ranks(group):
                mine[_block_key(path, lo, hi)] = t.to("cpu", copy=True)
        else:
            table[path] = {"shape": list(t.shape),
                           "dtype": str(t.dtype).removeprefix("torch."),
                           "blocks": None}
            if rank == 0:
                mine[path] = t.to("cpu", copy=True)
    return mine, table


@contextlib.contextmanager
def _single_process():
    """DCP without a process group, its warning that it assumes so
    silenced (that is the intent)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process")
        yield


def _dcp_save(entries: dict, directory: Path, group) -> None:
    import torch.distributed.checkpoint as dcp
    if group is None:
        with _single_process():
            dcp.save(entries, checkpoint_id=str(directory), no_dist=True)
    else:
        dcp.save(entries, checkpoint_id=str(directory), process_group=group)


def _finish(tmp: Path, path: Path, marker: dict, meta) -> None:
    """Every rank's bytes are durable: rank 0 writes the marker, swaps
    the directory into place and writes the sidecar; all ranks wait."""
    _barrier()
    if _rank() == 0:
        (tmp / MARKER).write_text(json.dumps(marker))
        _swap_into_place(tmp, path)
        if meta is not None:
            Path(str(path) + ".json").write_text(json.dumps(meta))
    _barrier()


def _swap_into_place(tmp: Path, path: Path) -> None:
    old = path.parent / f".{path.name}.tmp-old"
    if old.exists():
        shutil.rmtree(old)
    if path.exists():
        path.replace(old)
    tmp.replace(path)
    if old.exists():
        shutil.rmtree(old)


def save_sharded(path: str | Path, state, meta: Optional[dict] = None,
                 async_: bool = False) -> Path:
    """Write ``state`` (a ``TrainState``) as a sharded directory at
    ``path``; every rank calls it. With ``async_`` the call returns once
    the tensors are on the host; :func:`wait` finishes the save."""
    path = Path(path)
    wait(path)                          # finalize an in-flight async save
    group = ckpt_group() if _distributed() else None
    # a hidden sibling (the leading dot keeps retention globs away)
    tmp = path.parent / f".{path.name}.tmp-save"
    if _rank() == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    _barrier()
    entries, table = _entries(state)
    marker = {"format": FORMAT, "version": 1, "step": int(state.step),
              "leaves": table,
              "opt_state": _structure(state.opt_state, "opt_state")}
    if not async_:
        _dcp_save(entries, tmp, group)
        _finish(tmp, path, marker, meta)
        return path
    errors: list = []

    def write():
        try:
            _dcp_save(entries, tmp, group)
        except Exception as exc:              # raised again by wait()
            errors.append(exc)

    thread = threading.Thread(target=write, name=f"save {path.name}",
                              daemon=True)
    thread.start()
    _ASYNC[str(path)] = (thread, tmp, marker, meta, errors)
    return path


def async_save_sharded(path: str | Path, state,
                       meta: Optional[dict] = None) -> Path:
    """:func:`save_sharded` overlapping the write with training."""
    return save_sharded(path, state, meta, async_=True)


def wait(path: str | Path | None = None) -> None:
    """Make the async save(s) durable and swap them into place (all
    pending saves if ``path`` is None); every rank calls it."""
    keys = [str(Path(path))] if path is not None else list(_ASYNC)
    for k in keys:
        entry = _ASYNC.pop(k, None)
        if entry is None:
            continue
        thread, tmp, marker, meta, errors = entry
        thread.join()
        if errors:
            raise errors[0]
        _finish(tmp, Path(k), marker, meta)


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------
def _marker(path: Path) -> dict:
    m = json.loads((path / MARKER).read_text())
    if m.get("format") != FORMAT:
        raise ValueError(f"{path}: not a sharded train state "
                         f"({m.get('format')!r})")
    return m


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _read(path: Path, leaves: dict, ranges: dict) -> dict:
    """``{leaf: rows [lo, hi) of it}`` for ``ranges`` (leaf → ``(lo, hi)``,
    or None for the whole leaf), the row blocks that overlap each range
    read in one pass over the store (this process alone: no
    collective)."""
    import torch.distributed.checkpoint as dcp
    entries, plan = {}, {}
    for leaf, rng in ranges.items():
        if leaf not in leaves:
            raise ValueError(f"{path}: no leaf {leaf}")
        info = leaves[leaf]
        shape, dtype = info["shape"], _dtype(info["dtype"])
        lo, hi = rng if rng is not None else (0, shape[0] if shape else 0)
        if info["blocks"] is None:
            entries[leaf] = torch.empty(shape, dtype=dtype)
            plan[leaf] = (lo, hi, None)
            continue
        parts = []
        for b_lo, b_hi in info["blocks"]:
            if b_lo < hi and b_hi > lo:
                key = _block_key(leaf, b_lo, b_hi)
                entries[key] = torch.empty([b_hi - b_lo, *shape[1:]],
                                           dtype=dtype)
                parts.append((key, b_lo, b_hi))
        plan[leaf] = (lo, hi, parts)
    if entries:
        with _single_process():
            dcp.load(entries, checkpoint_id=str(path), no_dist=True)
    out = {}
    for leaf, (lo, hi, parts) in plan.items():
        if parts is None:
            whole = entries[leaf]
            out[leaf] = whole[lo:hi] if whole.dim() else whole
            continue
        shape = leaves[leaf]["shape"]
        t = torch.empty([hi - lo, *shape[1:]],
                        dtype=_dtype(leaves[leaf]["dtype"]))
        for key, b_lo, b_hi in parts:
            a, b = max(lo, b_lo), min(hi, b_hi)
            t[a - lo:b - lo] = entries[key][a - b_lo:b - b_lo]
        out[leaf] = t
    return out


def _tensor_paths(node) -> list:
    """The tensor leaves' paths of an optimizer structure."""
    if "items" in node:
        return [p for _, v in node["items"] for p in _tensor_paths(v)]
    if "tuple" in node:
        return [p for v in node["tuple"] for p in _tensor_paths(v)]
    return [node["t"]] if "t" in node else []


def _rebuild(node, fetch, template=None, path: str = "opt_state"):
    """The optimizer tree of a structure, its tensors from ``fetch``; with
    ``template``, ``ValueError`` where the two differ."""
    from speakerverification_tpu_torch.optim import LeafTree, ParamTree
    kinds = {"dict": dict, "ParamTree": ParamTree, "LeafTree": LeafTree}
    if "items" in node:
        keys = [k for k, _ in node["items"]]
        if template is not None and (not isinstance(template, dict)
                                     or list(template) != keys):
            raise ValueError(f"sharded checkpoint's optimizer state does "
                             f"not match at {path}: keys {keys}")
        return kinds[node["dict"]](
            (k, _rebuild(v, fetch, None if template is None else template[k],
                         f"{path}/{k}")) for k, v in node["items"])
    if "tuple" in node:
        if template is not None and (not isinstance(template, tuple)
                                     or len(template) != len(node["tuple"])):
            raise ValueError(f"sharded checkpoint's optimizer state does "
                             f"not match at {path}")
        return tuple(_rebuild(v, fetch, None if template is None
                              else template[i], f"{path}/{i}")
                     for i, v in enumerate(node["tuple"]))
    if "t" in node:
        if template is not None and not isinstance(template, torch.Tensor):
            raise ValueError(f"sharded checkpoint's optimizer state does "
                             f"not match at {path}")
        return fetch(node["t"], template)
    kind, v = node["type"], node["v"]
    return {"bool": bool, "int": int, "float": float}.get(
        kind, getattr(np, kind, float))(v)


def restore_sharded(path: str | Path, target):
    """Read the checkpoint into ``target`` (a ``TrainState``) in
    ``target``'s layout: a leaf ``target.shards`` names gets its rows
    only, any other leaf the whole array, whatever world size wrote it.
    ``ValueError`` when a leaf is missing or of another shape. Returns
    ``target``."""
    from speakerverification_tpu_torch.parallel.tp import state_leaves
    path = Path(path)
    if str(path) in _ASYNC:
        wait(path)
    m = _marker(path)
    leaves = m["leaves"]
    want = dict(state_leaves(target))
    ranges = {}
    for leaf in (p for p in want if p in leaves):
        if leaf in target.shards:
            lo, hi, rows, _ = target.shards[leaf]
            if leaf in leaves and rows != leaves[leaf]["shape"][0]:
                raise ValueError(f"{path}: {leaf} has "
                                 f"{leaves[leaf]['shape'][0]} rows, the "
                                 f"target {rows}")
            ranges[leaf] = (lo, hi)
        else:
            ranges[leaf] = None
    got = _read(path, leaves, ranges)

    def fetch(leaf: str, like: Optional[torch.Tensor]) -> torch.Tensor:
        if leaf not in got:
            raise ValueError(f"{path}: the checkpoint has no {leaf} "
                             "(another model or optimizer?)")
        t = got[leaf]
        if like is not None:
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{path}: {leaf} of shape "
                                 f"{tuple(t.shape)}, the target's "
                                 f"{tuple(like.shape)}")
            t = t.to(like.device, like.dtype)
        return t

    new = {p: fetch(p, want[p]) for p in want
           if p.startswith(("params/", "batch_stats/"))}
    opt_state = _rebuild(m["opt_state"], fetch, target.opt_state)
    with torch.no_grad():
        for p, t in new.items():
            want[p].copy_(t)
    target.opt_state = opt_state
    target.step = int(m["step"])
    return target


def raw_tree(path: str | Path, params_only: bool = False) -> dict:
    """The whole state as the JAX package's msgpack tree (``step``,
    ``params``, ``batch_stats``, ``opt_state`` in flax layout), every
    row block assembled; with ``params_only`` no optimizer state is read
    (its ``opt_state`` is empty)."""
    from speakerverification_tpu_torch.training.checkpoint import (
        _opt_to_jax,
    )
    from speakerverification_tpu_torch.weights import params_to_jax
    path = Path(path)
    m = _marker(path)
    leaves = m["leaves"]
    names = [leaf for leaf in leaves
             if leaf.partition("/")[0] in ("params", "batch_stats")]
    opt_paths = [] if params_only else _tensor_paths(m["opt_state"])
    got = _read(path, leaves, dict.fromkeys(names + opt_paths))
    sd = {leaf.partition("/")[2]: got[leaf] for leaf in names}
    params, stats = params_to_jax(sd)
    opt = {} if params_only else _opt_to_jax(
        _rebuild(m["opt_state"], lambda leaf, _: got[leaf]), sd)
    return {"step": np.asarray(m["step"], np.int32), "params": params,
            "batch_stats": stats, "opt_state": opt}
