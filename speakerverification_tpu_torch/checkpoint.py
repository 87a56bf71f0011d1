"""Checkpoints in the JAX package's layout (port of ``training/checkpoint.py``).

The JAX trainer writes flax msgpack: ``flax.serialization.to_bytes`` of a
``TrainState`` (``step``, ``params``, ``batch_stats``, ``opt_state``),
beside a JSON sidecar of training metadata. This module reads and writes
that layout with its own msgpack codec in pure Python, so that it needs
neither ``msgpack`` nor ``flax`` nor ``ml_dtypes``:

* maps, str/bin, ints, floats, nil/bool and arrays; ext type 1 is an
  ndarray packed as ``(shape, dtype name, C-order bytes)``, 2 a Python
  complex, 3 a numpy scalar;
* a leaf whose dtype is named ``bfloat16`` decodes to a
  ``torch.bfloat16`` tensor from its raw bytes (numpy has no such dtype);
* leaves above :data:`MAX_CHUNK_SIZE` bytes are stored as
  ``__msgpack_chunked_array__`` dicts and rejoined on reading;
* tuples and lists (an optax chain) are stored as dicts with index keys
  ``"0"``, ``"1"``, ..., as flax's state dicts store them.

A tree here is a nested ``dict`` with numpy or tensor leaves; a model's
weights are ``{"params": ..., "batch_stats": ...}`` in flax's layout
(``weights.params_to_jax``). The loaders keep the JAX package's
tolerance: a missing or shape-mismatched leaf stays at its initial value
and is reported; a present subtree that shares no leaf names with the
model's, or a load that restores nothing, raises. A checkpoint's
subtrees the template lacks (the ``loss`` head, for an engine that embeds
without one) are read and reported, not restored. The port's own
sharded checkpoint directories (``training/checkpoint_sharded.py``) and
the JAX package's orbax directories (``training/orbax_read.py``) load
through the same functions, assembled into the msgpack tree.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "msgpack_serialize", "msgpack_restore",
           "save_checkpoint", "load_checkpoint", "load_meta", "restore_into",
           "load_params_only", "load_ema_params", "average_checkpoints"]

# flax.serialization.MAX_CHUNK_SIZE: larger leaves are stored in chunks
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# msgpack codec
# ----------------------------------------------------------------------
class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")


_FIXED = {0xca: ">f", 0xcb: ">d", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i",
          0xd3: ">q"}


def _decode(r: _Reader) -> Any:
    b = r.uint(1)
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _decode_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in (0xc4, 0xc5, 0xc6):
        return bytes(r.take(r.uint(1 << (b - 0xc4))))
    if b in (0xc7, 0xc8, 0xc9):
        n = r.uint(1 << (b - 0xc7))
        return _decode_ext(r.uint(1), r.take(n))
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack(fmt, r.take(struct.calcsize(fmt)))[0]
    if 0xcc <= b <= 0xcf:
        return r.uint(1 << (b - 0xcc))
    if 0xd4 <= b <= 0xd8:
        code = r.uint(1)
        return _decode_ext(code, r.take(1 << (b - 0xd4)))
    if b in (0xd9, 0xda, 0xdb):
        return str(r.take(r.uint(1 << (b - 0xd9))), "utf-8")
    if b in (0xdc, 0xdd):
        return [_decode(r) for _ in range(r.uint(2 if b == 0xdc else 4))]
    if b in (0xde, 0xdf):
        return _decode_map(r, r.uint(2 if b == 0xde else 4))
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _decode_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _array_from(shape, name, buf) -> np.ndarray | torch.Tensor:
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        if not len(buf):
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) \
            .reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _decode_ext(code: int, data) -> Any:
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, name, buf = _decode(_Reader(data))
        arr = _array_from(shape, name, buf)
        if code == _EXT_NDARRAY:
            return arr
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        real, imag = _decode(_Reader(data))
        return complex(real, imag)
    raise ValueError(f"unknown msgpack ext type {code}")


def _index_list(d: dict) -> list:
    """A flax state dict of a tuple (``{"0": a, "1": b}``) as a list."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(int(s) for s in _index_list(tree["shape"]))
        chunks = _index_list(tree["chunks"])
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.asarray(c).reshape(-1)
                               for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes (``flax.serialization.msgpack_restore``):
    nested dicts with numpy leaves, ``torch.bfloat16`` tensors for bf16."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return _unchunk(out)


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7f:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for tag, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                              (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < lim:
                out += bytes([tag]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for tag, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                              (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -lim:
                out += bytes([tag]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix: Optional[int], fix_max: int,
              tags: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``tags`` (8-, 16-, 32-bit lengths; None where absent) that fits."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, lim in zip(tags, (">B", ">H", ">I"),
                             (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < lim:
            out += bytes([tag]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, (0xc7, 0xc8, 0xc9))
    out.append(code)
    out += data


def _array_bytes(x) -> bytes:
    """``(shape, dtype name, C-order bytes)`` packed, as flax packs an
    ndarray; a bf16 tensor is named ``bfloat16``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name, raw = tuple(x.shape), "bfloat16", \
                x.view(torch.int16).numpy().tobytes()
        else:
            x = x.numpy()
    if not isinstance(x, torch.Tensor):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be "
                             "serialized")
        shape, name, raw = x.shape, x.dtype.name, x.tobytes("C")
    out = bytearray()
    _encode([list(shape), name, raw], out)
    return bytes(out)


def _chunk(x) -> dict:
    """flax's chunked form of a leaf above MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    item = flat.element_size() if isinstance(flat, torch.Tensor) \
        else flat.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.shape[0], size))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.size * x.dtype.itemsize


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, 0, (0xc4, 0xc5, 0xc6))
        out += raw
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, list):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _array_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    elif isinstance(obj, complex):
        data = bytearray()
        _encode([obj.real, obj.imag], data)
        _pack_ext(_EXT_COMPLEX, bytes(data), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` for plain containers: tuples and lists
    become dicts with index keys, large leaves their chunked form."""
    if isinstance(tree, dict):
        return {k: _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree as flax does (``flax.serialization.to_bytes``)."""
    out = bytearray()
    _encode(_state_dict(tree), out)
    return bytes(out)


# ----------------------------------------------------------------------
# files
# ----------------------------------------------------------------------
def _read_directory(path: Path, params_only: bool, ema: bool) -> Any:
    """The raw tree of a checkpoint directory: the port's sharded format
    or the JAX package's orbax directory; anything else raises."""
    from speakerverification_tpu_torch.training import (
        checkpoint_sharded as sharded,
    )
    if sharded.is_sharded_checkpoint(path):
        return sharded.raw_tree(path, params_only=params_only)
    if sharded.is_orbax_checkpoint(path):
        from speakerverification_tpu_torch.training import orbax_read
        keep = (orbax_read.keep_params if params_only
                else orbax_read.keep_ema if ema else None)
        return orbax_read.read_orbax(path, keep=keep)
    raise ValueError(f"{path} is a directory but not a sharded checkpoint "
                     "of the port nor an orbax checkpoint of the JAX package")


def save_checkpoint(path: str | Path, tree: Any,
                    meta: Optional[dict] = None) -> Path:
    """Write ``tree`` as flax msgpack and ``meta`` as the ``<path>.json``
    sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(tree))
    if meta is not None:
        path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta))
    return path


def load_checkpoint(path: str | Path, params_only: bool = False,
                    ema: bool = False) -> Any:
    """The raw tree of a msgpack checkpoint, of the port's sharded
    checkpoint directory (``training/checkpoint_sharded.py``) or of the
    JAX package's orbax directory (``training/orbax_read.py``), the
    directories assembled into the msgpack tree. ``params_only`` spares a
    directory's optimizer state the read; ``ema`` reads an orbax
    directory's ``ema`` subtree and batch stats only."""
    path = Path(path)
    if path.is_dir():
        return _read_directory(path, params_only, ema)
    return msgpack_restore(path.read_bytes())


def load_meta(path: str | Path) -> dict:
    side = Path(str(path) + ".json")
    return json.loads(side.read_text()) if side.exists() else {}


# ----------------------------------------------------------------------
# tolerant merges
# ----------------------------------------------------------------------
def _collect_leaf_paths(node, path: str, out: list) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _collect_leaf_paths(v, f"{path}/{k}", out)
    else:
        out.append(path or "<root>")


def _n_leaves(node) -> int:
    if isinstance(node, dict):
        return sum(_n_leaves(v) for v in node.values())
    return 0 if node is None else 1


def _shape(x) -> Optional[tuple]:
    shape = getattr(x, "shape", None)
    return None if shape is None else tuple(shape)


def restore_into(params, saved_params) -> tuple[Any, list[str]]:
    """Merge ``saved_params`` into ``params`` leaf by leaf, keeping a
    missing or shape-mismatched leaf. Returns ``(merged, skipped)``."""
    skipped: list[str] = []

    def merge(path: str, cur, saved):
        if isinstance(cur, dict):
            if not isinstance(saved, dict):
                _collect_leaf_paths(cur, path, skipped)
                return cur
            out = {}
            for k, v in cur.items():
                if k in saved:
                    out[k] = merge(f"{path}/{k}", v, saved[k])
                else:
                    _collect_leaf_paths(v, f"{path}/{k}", skipped)
                    out[k] = v
            return out
        if saved is None or _shape(saved) != _shape(cur):
            skipped.append(path)
            return cur
        return saved

    return merge("", params, saved_params), skipped


def _tolerant(path, cur, saved, what: str):
    """restore_into with the JAX loader's guards: a bare backbone tree is
    accepted; a present subtree sharing no leaf names with the model's,
    or a load that restores nothing, raises."""
    if (isinstance(cur, dict) and "backbone" in cur
            and isinstance(saved, dict) and "backbone" not in saved):
        saved = {"backbone": saved}
    merged, skipped = restore_into(cur, saved)
    if isinstance(cur, dict) and isinstance(saved, dict):
        for key in set(cur) & set(saved):
            cur_paths: list = []
            _collect_leaf_paths(cur[key], f"/{key}", cur_paths)
            saved_paths: list = []
            _collect_leaf_paths(saved[key], f"/{key}", saved_paths)
            if (cur_paths and saved_paths
                    and not set(cur_paths) & set(saved_paths)):
                raise ValueError(
                    f"{path}: the checkpoint's {what} '{key}' subtree "
                    f"shares no leaf names with the model's "
                    f"{len(cur_paths)} (first model leaves: "
                    f"{cur_paths[:3]}) — wrong architecture?")
        extra = sorted(set(saved) - set(cur))
        if extra:
            print(f"[load_params_only] the checkpoint's {what} subtrees "
                  f"{extra} were read and not restored (the model was "
                  "built without them)")
    total = _n_leaves(cur)
    if total and len(skipped) >= total and _n_leaves(saved):
        raise ValueError(
            f"{path}: no {what} leaf restored — every entry is missing or "
            f"shape-mismatched (first: {skipped[:3]}) — wrong architecture "
            "or config?")
    if skipped:
        print(f"[load_params_only] {len(skipped)} {what} leaves kept from "
              f"init (not in checkpoint or shape-mismatched), e.g. "
              f"{skipped[:3]}")
    return merged


def load_params_only(path: str | Path, state: dict) -> dict:
    """``state`` (``{"params": ..., "batch_stats": ...}``) with the
    checkpoint's params and batch statistics merged in."""
    raw = load_checkpoint(path, params_only=True)
    new = dict(state)
    new["params"] = _tolerant(path, state["params"], raw["params"], "param")
    if raw.get("batch_stats"):
        new["batch_stats"] = _tolerant(path, state["batch_stats"],
                                       raw["batch_stats"], "batch_stats")
    return new


def _find_ema(node):
    """The ``track_ema`` subtree of an optimizer state: the first dict
    under an ``"ema"`` key (a chain is a dict with index keys)."""
    if isinstance(node, dict):
        if isinstance(node.get("ema"), dict):
            return node["ema"]
        children = node.values()
    elif isinstance(node, (list, tuple)):
        children = node
    else:
        return None
    for v in children:
        found = _find_ema(v)
        if found is not None:
            return found
    return None


def _strict(path, cur, saved, what: str):
    """``saved`` laid over ``cur`` where every leaf of ``cur`` must be
    present with its shape; leaves ``cur`` lacks (the loss head's) are
    left out."""
    merged, skipped = restore_into(cur, saved)
    if skipped:
        raise ValueError(f"{path}: the checkpoint's {what} do not match "
                         f"the model: {skipped[:3]}")
    return merged


def load_ema_params(path: str | Path, state: dict) -> Optional[dict]:
    """``state`` with the checkpoint's EMA weights (``optim.track_ema``)
    as params and its batch statistics, or None when the checkpoint was
    trained without ``optimizer.ema_decay``."""
    raw = load_checkpoint(path, ema=True)
    ema = _find_ema(raw.get("opt_state", {}))
    if ema is None:
        return None
    new = dict(state)
    new["params"] = _strict(path, state["params"], ema, "EMA params")
    if raw.get("batch_stats"):
        new["batch_stats"] = _strict(path, state["batch_stats"],
                                     raw["batch_stats"], "batch_stats")
    return new


def _mean(xs, n: float):
    x0 = xs[0]
    if isinstance(x0, torch.Tensor):
        if not x0.is_floating_point():
            return x0
        return (sum(x.float() for x in xs) / n).to(x0.dtype)
    x0 = np.asarray(x0)
    if not np.issubdtype(x0.dtype, np.floating):
        return xs[0]                       # counts etc.: keep the first
    acc = sum(np.asarray(x).astype(np.float32) for x in xs) / np.float32(n)
    return acc.astype(x0.dtype)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(list(trees))


def average_checkpoints(paths, state: dict) -> dict:
    """The uniform average ("model soup") of the checkpoints' params and
    batch statistics, each loaded into ``state``: floating leaves are
    averaged in fp32 and cast back, integer leaves are the first
    checkpoint's."""
    paths = [Path(p) for p in paths]
    if not paths:
        raise ValueError("average_checkpoints: no checkpoint paths given")
    loaded = [load_params_only(p, state) for p in paths]
    n = float(len(loaded))
    new = dict(state)
    new["params"] = _tree_map(lambda xs: _mean(xs, n),
                              *[s["params"] for s in loaded])
    if loaded[0].get("batch_stats"):
        new["batch_stats"] = _tree_map(lambda xs: _mean(xs, n),
                                       *[s["batch_stats"] for s in loaded])
    return new
