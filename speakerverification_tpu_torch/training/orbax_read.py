"""Read the JAX package's orbax checkpoint directories without orbax.

The JAX trainer's ``sharded_checkpoints: true`` writes each state with
orbax (``StandardCheckpointer``) into an OCDBT key-value store
(TensorStore's "optionally-cooperative distributed b-tree"), with every
array a zarr v2 array inside it. This module reads that layout with
numpy, the port's own zstd decoder (``native/zstd.cpp``, built with g++
at first use) and nothing else, and returns the nested dict of numpy
arrays that ``checkpoint.msgpack_restore`` returns for the same state
saved as flax msgpack (a sequence's items under index keys ``"0"``,
``"1"``, …; a ``bfloat16`` leaf as a ``torch.bfloat16`` tensor).

The directory (orbax 0.11):

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf to its path
  (``key_metadata``: the keys, ``key_type`` 1 for a sequence index, 2 for
  a dict key) and ``value_metadata``; ``use_ocdbt`` must be true and
  ``use_zarr3`` false.
* ``manifest.ocdbt`` and ``d/<hash>``: the store. Each process writes its
  own store under ``ocdbt.process_<N>/``; the root manifest's b-tree
  refers into them by path.
* ``_CHECKPOINT_METADATA``, ``_sharding``, ``array_metadatas/``: not read.

The OCDBT format (TensorStore's "OCDBT storage format" page): a manifest
or b-tree node file is ``magic (u32 BE) · length (u64 LE) · version
(varint) · compression (varint: 0 none, 1 zstd) · body · CRC-32C (u32
LE)`` of everything before it. The manifest's body holds the config,
then the newest versions of the version tree (struct of arrays), whose
last entry points at the root b-tree node by (data file, offset,
length). A node holds its data-file table (prefix-compressed paths), its
keys (prefix-compressed, relative to the node's key prefix) and, in a
leaf, each value inline or as (data file, offset, length); an interior
node holds its children's references and the common prefix each child's
keys share. Paths are relative to the directory of the manifest read.

A zarr v2 array ``<leaf>`` is ``<leaf>/.zarray`` (JSON: shape, chunks,
dtype, ``order: C``, zstd compressor) plus one value per chunk,
``<leaf>/<i>.<j>…`` (``0`` for a scalar), each a zstd frame of a whole
chunk in C order. A leaf sharded over devices has one chunk per shard.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

__all__ = ["zstd_decompress", "zstd_content_size", "crc32c", "OcdbtStore",
           "read_orbax", "keep_params", "keep_ema"]

# ----------------------------------------------------------------------
# the native decoder
# ----------------------------------------------------------------------
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "svz_content_size": ([ctypes.c_char_p, ctypes.c_size_t],
                         ctypes.c_longlong),
    "svz_decompress": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                        ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p,
                        ctypes.c_size_t], ctypes.c_longlong),
    "svz_decompress_alloc": ([ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.POINTER(_U8P), ctypes.c_int,
                              ctypes.c_char_p, ctypes.c_size_t],
                             ctypes.c_longlong),
    "svz_free": ([_U8P], None),
    "svz_crc32c": ([ctypes.c_char_p, ctypes.c_size_t], ctypes.c_uint),
    "svz_coverage": ([ctypes.POINTER(ctypes.c_longlong), ctypes.c_int],
                     ctypes.c_int),
    "svz_coverage_reset": ([], None),
}
_lib = None
_lock = threading.Lock()


def _zstd():
    """The native decoder, built on first use. No fallback: without a
    C++ compiler the read fails, naming the decoder."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                from speakerverification_tpu_torch.ops import _build
                try:
                    _lib = _build.load_host("zstd", _SIGNATURES)
                except (OSError, RuntimeError,
                        subprocess.SubprocessError) as exc:
                    raise RuntimeError(
                        "the port's zstd decoder (native/zstd.cpp) could "
                        f"not be built or loaded: {exc}") from exc
    return _lib


def zstd_content_size(data: bytes) -> Optional[int]:
    """The first frame's stated content size, or None when its header
    states none."""
    n = _zstd().svz_content_size(bytes(data), len(data))
    if n == -2:
        raise ValueError("zstd: malformed frame header")
    return None if n < 0 else int(n)


def zstd_decompress(data: bytes, size: Optional[int] = None) -> np.ndarray:
    """Decode zstd frame(s) (RFC 8878) into a ``uint8`` array; ``size``,
    when known, is the exact decoded size (the frames are decoded in
    place into the array). Content checksums are checked."""
    lib = _zstd()
    data = bytes(data)
    err = ctypes.create_string_buffer(512)
    if size is not None:
        out = np.empty(int(size), np.uint8)
        n = lib.svz_decompress(data, len(data), out.ctypes.data, out.size, 1,
                               err, len(err))
        if n < 0:
            raise ValueError(err.value.decode())
        if n != size:
            raise ValueError(f"zstd: {n} bytes decoded, {size} expected")
        return out
    ptr = _U8P()
    n = lib.svz_decompress_alloc(data, len(data), ctypes.byref(ptr), 1, err,
                                 len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    try:
        out = np.empty(n, np.uint8)
        ctypes.memmove(out.ctypes.data, ptr, n)
        return out
    finally:
        lib.svz_free(ptr)


def crc32c(data: bytes) -> int:
    data = bytes(data)
    return int(_zstd().svz_crc32c(data, len(data)))


# ----------------------------------------------------------------------
# OCDBT
# ----------------------------------------------------------------------
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("OCDBT: record ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("OCDBT: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its checksum checked."""
    if len(raw) < 16 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"OCDBT: {what} has a wrong magic number")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"OCDBT: {what} is not as long as its header says")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"OCDBT: {what} fails its CRC-32C")
    r = _Reader(raw, 12)
    version = r.varint()
    if version != 0:
        raise ValueError(f"OCDBT: {what} has format version {version}")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body).tobytes()
    raise ValueError(f"OCDBT: {what} has compression {compression}")


def _data_files(r: _Reader) -> list:
    n = r.varint()
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                            # base path lengths
    paths, prev = [], b""
    for i in range(n):
        p = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        path = p.decode()
        if path.startswith("/") or ".." in Path(path).parts:
            raise ValueError(f"OCDBT: data file {path!r} lies outside the "
                             "store")
        paths.append(path)
        prev = p
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> tuple:
    """A node's keys and, in an interior node, the length of the prefix
    each child's keys share (its lengths come before the key bytes)."""
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        k = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        keys.append(k)
        prev = k
    return keys, common


class OcdbtStore:
    """An OCDBT store on disk (read only): ``store[key]`` is a value's
    bytes, ``keys()`` every key, read from the newest version."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.exists():
            raise ValueError(f"{self.root}: no manifest.ocdbt (an OCDBT "
                             "store that was not finalized?)")
        body = _unframe(manifest.read_bytes(), _MANIFEST_MAGIC,
                        f"{manifest}")
        r = _Reader(body)
        r.take(16)                          # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: manifest kind {kind} (numbered "
                             "manifests) is not read")
        r.varint()                          # max inline value bytes
        r.varint()                          # max decoded node bytes
        r.u8()                              # version tree arity log2
        if r.varint() == 1:                 # zstd nodes: their level
            r.take(4)
        files = _data_files(r)
        n = r.varint()
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        if not n:
            raise ValueError(f"{manifest}: no version to read (the newest "
                             "versions are not inline)")
        i = max(range(n), key=gen.__getitem__)
        self._entries: dict = {}
        self._files: dict = {}
        if length[i]:
            self._walk(files[fid[i]], off[i], length[i], height[i], b"")

    # -- nodes
    def _read(self, path: str, offset: int, length: int) -> bytes:
        f = self._files.get(path)
        if f is None:
            f = self._files[path] = open(self.root / path, "rb")
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {self.root / path} ends before byte "
                             f"{offset + length}")
        return data

    def _walk(self, path, offset, length, height, prefix: bytes) -> None:
        body = _unframe(self._read(path, offset, length), _NODE_MAGIC,
                        f"b-tree node {path}@{offset}")
        r = _Reader(body)
        if r.u8() != height:
            raise ValueError(f"OCDBT: node {path}@{offset} has another "
                             "height than its reference")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError(f"OCDBT: value kinds {sorted(set(kinds))}")
            m = sum(kinds)
            ids, offs = r.varints(m), r.varints(m)
            inline = r.take(sum(v for v, k in zip(lengths, kinds) if not k))
            at = j = 0
            for key, vlen, kind in zip(keys, lengths, kinds):
                if kind:                    # (data file, offset, length)
                    ref = (files[ids[j]], offs[j], vlen)
                    j += 1
                else:
                    ref = inline[at:at + vlen]
                    at += vlen
                self._entries[prefix + key] = ref
            return
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n)                        # keys below each child
        r.varints(n)                        # tree bytes
        r.varints(n)                        # indirect value bytes
        for key, c, i, o, ln in zip(keys, common, ids, offs, lens):
            self._walk(files[i], o, ln, height - 1, prefix + key[:c])

    # -- values
    def keys(self) -> list:
        return sorted(self._entries)

    def __contains__(self, key) -> bool:
        return _b(key) in self._entries

    def __getitem__(self, key) -> bytes:
        ref = self._entries[_b(key)]
        if isinstance(ref, bytes):
            return ref
        return self._read(*ref)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def _b(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


# ----------------------------------------------------------------------
# zarr v2
# ----------------------------------------------------------------------
_DTYPES = {"<f4", "<f8", "<f2", "<i1", "|i1", "<i2", "<i4", "<i8", "<u1",
           "|u1", "<u2", "<u4", "<u8", "|b1", "bfloat16"}


def _read_zarr(store: OcdbtStore, name: str):
    meta_key = f"{name}/.zarray"
    if meta_key not in store:
        raise ValueError(f"{store.root}: the store has no array {name!r}")
    meta = json.loads(store[meta_key])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')} "
                         "(only zarr v2 is read)")
    dtype = meta["dtype"]
    if not isinstance(dtype, str) or dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype!r} is not one the JAX "
                         "package's states carry")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C-order arrays without filters "
                         "are read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} (only "
                         "zstd is read)")
    sep = meta.get("dimension_separator", ".")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    np_dtype = np.dtype("<u2" if dtype == "bfloat16" else dtype)
    out = np.empty(shape, np_dtype)
    grid = [-(-s // c) if c else 1 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * np_dtype.itemsize
    for idx in np.ndindex(*grid):           # () once for a scalar
        key = f"{name}/{sep.join(str(i) for i in idx) if idx else '0'}"
        if key not in store:
            raise ValueError(f"{name}: chunk {key!r} is missing (fill "
                             "values are not stored for these arrays)")
        raw = store[key]
        data = (zstd_decompress(raw, chunk_bytes) if comp is not None
                else np.frombuffer(raw, np.uint8))
        if data.size != chunk_bytes:
            raise ValueError(f"{name}: chunk {key!r} holds {data.size} "
                             f"bytes, {chunk_bytes} expected")
        block = data.view(np_dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[sel] = block[tuple(slice(0, t.stop - t.start) for t in sel)]
    if dtype == "bfloat16":
        import torch
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ----------------------------------------------------------------------
# the checkpoint
# ----------------------------------------------------------------------
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY_TYPES = ("None", "Dict", "List", "Tuple")


def _metadata(path: Path) -> dict:
    md_path = path / "_METADATA"
    if not md_path.exists():
        raise ValueError(f"{path}: an orbax directory without _METADATA "
                         "(not written by StandardCheckpointer?)")
    md = json.loads(md_path.read_text())
    if md.get("use_zarr3"):
        raise ValueError(f"{path}: the orbax directory has use_zarr3 true; "
                         "the port reads zarr v2 arrays only")
    if not md.get("use_ocdbt", False):
        raise ValueError(f"{path}: the orbax directory has use_ocdbt false; "
                         "the port reads OCDBT stores only")
    return md["tree_metadata"]


def keep_params(keys: tuple) -> bool:
    """The leaves ``load_params_only`` reads: params and batch stats."""
    return keys[0] in ("params", "batch_stats")


def keep_ema(keys: tuple) -> bool:
    """The leaves ``load_ema_params`` reads: the optimizer state's
    ``ema`` subtree (``optim.track_ema``) and the batch stats."""
    return keys[0] == "batch_stats" or (keys[0] == "opt_state"
                                        and "ema" in keys[1:])


def read_orbax(path: str | Path,
               keep: Optional[Callable[[tuple], bool]] = None) -> dict:
    """The state in an orbax directory as the nested dict of numpy
    arrays that ``checkpoint.msgpack_restore`` gives for the same state
    saved as msgpack. ``keep(keys)`` chooses the leaves read (by their
    key path); the others are neither read nor in the tree."""
    path = Path(path)
    tree_md = _metadata(path)
    store = None
    tree: dict = {}
    try:
        for entry in tree_md.values():
            keys = tuple(str(k["key"]) for k in entry["key_metadata"])
            if keep is not None and not keep(keys):
                continue
            value = entry.get("value_metadata") or {}
            vtype = value.get("value_type")
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            if vtype in _ARRAY_TYPES:
                if store is None:
                    store = OcdbtStore(path)
                node[keys[-1]] = _read_zarr(store, ".".join(keys))
            elif vtype in _EMPTY_TYPES:
                # an empty node (optax's EmptyState, an empty dict), which
                # flax's msgpack stores as an empty map
                node.setdefault(keys[-1], {})
            else:
                raise ValueError(f"{path}: leaf {'/'.join(keys)} has value "
                                 f"type {vtype!r}, which the port does "
                                 "not read")
    finally:
        if store is not None:
            store.close()
    return tree
