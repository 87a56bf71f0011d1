"""Packed shards (port of ``data/shards.py``): crop-sized reads instead
of one file per utterance.

``pack_shards`` rewrites a manifest's WAVs once into a few large shards
of concatenated raw little-endian int16 PCM and a JSON index; at train
time ``ShardedAudioSource`` memory-maps the shards and serves each crop
as one read of ``max_audio`` samples: no open, no header parse, no
decode. Values are scaled by 1/32768, as ``data/wavio.py`` decodes
16-bit PCM, so a crop equals the file path's for mono 16-bit sources;
other sources (stereo, 24/32-bit, float) are quantized once to int16 at
pack time (at most half a step) and counted as ``requantized``.

Index (``shard_index.json``), the JAX package's format, so that a pack
written by either package loads in the other::

    {"version": 1, "sample_rate": N, "manifest_sha1": "...",
     "shards": ["shard-00000.bin", ...],
     "utts": [[shard_i, offset_samples, length_samples, label, key], ...]}

``utts`` is in manifest order: the loader's manifest indices address it
directly; ``key`` is the source path.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Mapping, Optional, Sequence, Union

import numpy as np

from speakerverification_tpu_torch.data.audio import AudioSpec, load_wav
from speakerverification_tpu_torch.data.wavio import read_wav

__all__ = ["manifest_fingerprint", "pack_shards", "ShardedAudioSource",
           "INDEX_NAME"]

INDEX_NAME = "shard_index.json"


def manifest_fingerprint(paths: Sequence[str]) -> str:
    """Order-sensitive SHA-1 of the whole path list (a same-length
    manifest whose middle changed must not pass)."""
    h = hashlib.sha1()
    for p in paths:
        h.update(str(p).encode())
        h.update(b"\n")
    return h.hexdigest()


def pack_shards(manifest, out_dir: Union[str, Path], shard_mb: int = 1024,
                sample_rate: Optional[int] = None) -> dict:
    """Pack every utterance of ``manifest`` (``paths``, ``labels``) into
    shards of at most ``shard_mb`` MiB under ``out_dir`` and write the
    index. ``sample_rate`` (default: the first file's) holds for every
    file. Returns ``{"utts", "shards", "samples", "bytes",
    "requantized"}``."""
    if len(manifest.paths) == 0:
        raise ValueError("manifest has no utterances — nothing to pack")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cap = int(shard_mb) * (1 << 20) // 2          # int16 samples per shard
    utts, shards = [], []
    cur, cur_samples, total, requantized = None, 0, 0, 0

    def open_next():
        nonlocal cur, cur_samples
        if cur is not None:
            cur.close()
        name = f"shard-{len(shards):05d}.bin"
        shards.append(name)
        cur = open(out / name, "wb")
        cur_samples = 0

    try:
        open_next()
        for i, path in enumerate(manifest.paths):
            audio, sr = read_wav(path)
            if sample_rate is None:
                sample_rate = int(sr)
            elif int(sr) != int(sample_rate):
                raise ValueError(f"{path}: sample rate {sr} != {sample_rate}")
            audio = np.asarray(audio, np.float32)
            pcm = np.clip(np.round(audio * 32768.0), -32768,
                          32767).astype("<i2")
            if not np.array_equal(pcm.astype(np.float32) / 32768.0, audio):
                requantized += 1
            if cur_samples and cur_samples + len(pcm) > cap:
                open_next()
            utts.append([len(shards) - 1, cur_samples, int(len(pcm)),
                         int(manifest.labels[i]), str(path)])
            cur.write(pcm.tobytes())
            cur_samples += len(pcm)
            total += len(pcm)
    finally:
        if cur is not None:
            cur.close()

    index = {"version": 1, "sample_rate": int(sample_rate),
             "manifest_sha1": manifest_fingerprint(manifest.paths),
             "shards": shards, "utts": utts}
    tmp = out / (INDEX_NAME + ".tmp")
    tmp.write_text(json.dumps(index))
    os.replace(tmp, out / INDEX_NAME)
    return {"utts": len(utts), "shards": len(shards), "samples": total,
            "bytes": total * 2, "requantized": requantized}


class ShardedAudioSource:
    """Reads a ``pack_shards`` directory through memory maps.

    ``crop_train(i, spec, rng)`` gives what ``load_wav(path, spec,
    evalmode=False, rng=rng)`` gives for utterance ``i`` (the same
    pad-wrap, the same single ``rng.random()`` draw), reading only the
    crop's samples."""

    def __init__(self, shard_dir: Union[str, Path]):
        d = Path(shard_dir)
        idx_path = d / INDEX_NAME
        if not idx_path.exists():
            raise FileNotFoundError(f"no {INDEX_NAME} in {d}")
        index = json.loads(idx_path.read_text())
        if index.get("version") != 1:
            raise ValueError(f"unsupported shard index version "
                             f"{index.get('version')!r}")
        self.sample_rate = int(index["sample_rate"])
        self.manifest_sha1 = index.get("manifest_sha1")
        self.utts = index["utts"]
        self._by_key = None           # built on first use of index_of
        self._maps = [np.memmap(d / name, dtype="<i2", mode="r")
                      for name in index["shards"]]

    def __len__(self) -> int:
        return len(self.utts)

    def index_of(self, key: str) -> int:
        if self._by_key is None:
            self._by_key = {u[4]: i for i, u in enumerate(self.utts)}
        return self._by_key[key]

    def _slice(self, i: int, start: int, n: int) -> np.ndarray:
        shard, off = self.utts[i][:2]
        return (self._maps[shard][off + start:off + start + n]
                .astype(np.float32) / 32768.0)

    def load(self, i: Union[int, str]) -> np.ndarray:
        """The whole utterance, float32 scaled by 1/32768."""
        if isinstance(i, str):
            i = self.index_of(i)
        return self._slice(i, 0, self.utts[i][2])

    def label(self, i: int) -> int:
        return int(self.utts[i][3])

    def crop_train(self, i: int, spec: Mapping,
                   rng: Optional[np.random.Generator] = None,
                   random_chunk: bool = True) -> np.ndarray:
        """One train crop ``[1, max_audio]``. A long utterance is one read
        at the drawn offset; a short one is read whole and pad-wrapped by
        ``load_wav``."""
        spec = AudioSpec(spec)
        max_audio = spec.max_audio
        length = self.utts[i][2]
        if length <= max_audio:
            return load_wav(self._slice(i, 0, length), spec, evalmode=False,
                            random_chunk=random_chunk, rng=rng,
                            normalize=False)
        if random_chunk:
            rng = rng or np.random.default_rng()
            start = int(rng.random() * (length - max_audio))
        else:
            start = 0
        return np.expand_dims(self._slice(i, start, max_audio), 0)

    def crops_eval(self, i: Union[int, str], spec: Mapping,
                   num_eval: int = 10) -> np.ndarray:
        """Eval crops ``[num_eval, max_audio]`` at ``load_wav``'s linspace
        offsets."""
        if isinstance(i, str):
            i = self.index_of(i)
        return load_wav(self.load(i), spec, num_eval, evalmode=True,
                        normalize=False)
