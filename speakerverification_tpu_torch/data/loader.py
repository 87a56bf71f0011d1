"""Batched eval-crop loading over unique trial files (port of
``EvalDataLoader`` from ``data/loader.py``)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping

import numpy as np

from speakerverification_tpu_torch.data.audio import AudioSpec, load_wav

__all__ = ["EvalDataLoader"]


def _usable_cpus() -> int:
    """CPUs this process may run on (affinity-aware; ``os.cpu_count()``
    reports the machine, not the container's limit)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:                       # non-Linux
        return os.cpu_count() or 1


class EvalDataLoader:
    """Files decoded by a thread pool and yielded as ``([B, num_eval, T]
    float32, paths)`` batches.

    Every batch, the last included, has exactly ``batch_size`` rows: the
    ragged remainder is padded by repeating its last file, so the model
    always sees one batch shape. ``paths`` holds only the real files;
    consumers drop the padded rows with ``emb[:len(paths)]``. Decode
    threads are clamped to the usable CPUs (oversubscribed threads on a
    small host thrash the GIL)."""

    def __init__(self, files, audio_spec: Mapping, num_eval: int = 10,
                 batch_size: int = 32, num_workers: int = 8):
        self.files = list(files)
        self.spec = AudioSpec(audio_spec)
        self.num_eval = num_eval
        # whole-file mode (num_eval 0) gives variable-length [1, T_file]
        # arrays, which cannot be stacked: one file per batch
        self.batch_size = 1 if num_eval == 0 else batch_size
        self.num_workers = max(1, min(num_workers, _usable_cpus()))

    def __len__(self) -> int:
        return (len(self.files) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple]:
        def load(path):
            return load_wav(path, self.spec, num_eval=self.num_eval)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(0, len(self.files), self.batch_size):
                chunk = self.files[b:b + self.batch_size]
                waves = list(pool.map(load, chunk))
                if len(waves) < self.batch_size:
                    waves.extend([waves[-1]] * (self.batch_size - len(waves)))
                yield np.stack(waves), chunk
