"""Data loaders (port of ``data/loader.py``): batched eval crops over
unique trial files (``EvalDataLoader``), and speaker-balanced training
batches (``TrainDataLoader``, ``train_data_loader``).

Training batches are ``{"wave": [B, nPerSpeaker, T] float32, "label":
[B] int32}``: a thread pool cuts one random crop per utterance, each
tuple from its own ``numpy`` generator seeded from the epoch's, and a
background thread keeps ``prefetch`` batches ready. The draws are the
JAX loader's, so the same manifest and seed give the same batches.

With ``augment: true`` each crop goes through ``augment_options``'
``augment_chain`` in the JAX loader's order, every draw from the tuple's
generator: ``time_domain`` (``data/augment.py``), a re-crop to the crop
length that keeps the gain, then ``env_corrupt`` (MUSAN noise and
simulated RIRs).

With packed shards (``dataloader_options.shards``, written by
``cli.dataprep --pack``; ``data/shards.py``) each crop is one read from
a memory-mapped shard instead of a WAV decode, with the same draws, so
the batches are the file path's. A pack of another sample rate, length
or manifest is refused.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping, Optional

import numpy as np

from speakerverification_tpu_torch.data.audio import AudioSpec, load_wav
from speakerverification_tpu_torch.data.augment import (
    AugmentWav,
    random_time_domain_augment,
)
from speakerverification_tpu_torch.data.manifest import Manifest
from speakerverification_tpu_torch.data.sampler import SpeakerBatchSampler
from speakerverification_tpu_torch.data.shards import (
    ShardedAudioSource,
    manifest_fingerprint,
)

__all__ = ["EvalDataLoader", "TrainDataLoader", "train_data_loader"]


def _usable_cpus() -> int:
    """CPUs this process may run on (affinity-aware; ``os.cpu_count()``
    reports the machine, not the container's limit)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:                       # non-Linux
        return os.cpu_count() or 1


def _check_pack(source: ShardedAudioSource, manifest: Manifest,
                sample_rate: int) -> None:
    """Refuse a pack that is not this manifest's at this sample rate (the
    file path checks the rate per file; a stale pack would train on
    time-stretched or mislabeled audio)."""
    repack = "repack (cli.dataprep --pack)"
    if source.sample_rate != sample_rate:
        raise ValueError(
            f"shard pack is {source.sample_rate} Hz but "
            f"audio_spec.sample_rate={sample_rate} — {repack}")
    if len(source) != len(manifest):
        raise ValueError(f"shard index has {len(source)} utts, manifest "
                         f"{len(manifest)} — {repack}")
    want = manifest_fingerprint(manifest.paths)
    if source.manifest_sha1 is not None and source.manifest_sha1 != want:
        raise ValueError(
            "shard index was packed from a different manifest (sha1 "
            f"{source.manifest_sha1[:12]} != {want[:12]}) — {repack}")


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


class TrainDataLoader:
    def __init__(self, manifest: Manifest, audio_spec: Mapping,
                 batch_size: int, nPerSpeaker: int = 1,
                 max_seg_per_spk: int = 500, augment: bool = False,
                 augment_options: Optional[Mapping] = None,
                 random_chunk: bool = True, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0, num_replicas: int = 1,
                 rank: int = 0,
                 shard_source: Optional[ShardedAudioSource] = None):
        self.manifest = manifest
        self.spec = AudioSpec(audio_spec)
        self.shard_source = shard_source
        if shard_source is not None:
            _check_pack(shard_source, manifest, self.spec.sample_rate)
        self.batch_size = batch_size
        self.n_per_speaker = nPerSpeaker
        self.random_chunk = random_chunk
        self.num_workers = max(1, min(num_workers, _usable_cpus()))
        self.prefetch = prefetch
        self.seed = seed
        self.sampler = SpeakerBatchSampler(
            manifest.labels, batch_size, nPerSpeaker, max_seg_per_spk,
            seed=seed, num_replicas=num_replicas, rank=rank)
        if len(self.sampler) == 0:
            raise ValueError(
                f"sampler yields zero batches: batch_size={batch_size} "
                f"(x{num_replicas} replicas) needs that many DISTINCT "
                f"speakers per batch, but the manifest has "
                f"{manifest.num_classes} speakers / {len(manifest)} "
                f"utterances (nPerSpeaker={nPerSpeaker}). Reduce batch_size "
                f"or nPerSpeaker.")

        self.augment = augment
        self.augment_options = augment_options or {}
        self.augment_chain = list(self.augment_options.get("augment_chain",
                                                           []) or [])
        # the env_corrupt engine, when there are files to corrupt with; the
        # trainer detaches it when env_corrupt runs on the device
        self.augmentor: Optional[AugmentWav] = None
        if augment and "env_corrupt" in self.augment_chain:
            engine = AugmentWav(self.augment_options, audio_spec)
            if engine.has_noise or engine.has_reverb:
                self.augmentor = engine

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _load_tuple(self, index_tuple, rng: np.random.Generator) -> np.ndarray:
        time_domain = self.augment and "time_domain" in self.augment_chain
        augmentor = self.augmentor
        crops = []
        for idx in index_tuple:
            if self.shard_source is not None:
                audio = self.shard_source.crop_train(
                    idx, self.spec, rng=rng, random_chunk=self.random_chunk)
            else:
                audio = load_wav(self.manifest.paths[idx], self.spec,
                                 evalmode=False,
                                 random_chunk=self.random_chunk, rng=rng)
            if time_domain:
                audio = random_time_domain_augment(
                    audio, self.augment_options.get("augment_time_domain",
                                                    {}) or {}, rng=rng)
                # speed changes the length: re-crop to T, without the
                # peak normalization that would undo a volume gain
                audio = load_wav(audio[0], self.spec, evalmode=False,
                                 random_chunk=self.random_chunk, rng=rng,
                                 normalize=False)
            if augmentor is not None:
                audio = augmentor.env_corrupt(audio, rng)
            crops.append(audio[0][:self.spec.max_audio].astype(np.float32))
        return np.stack(crops, axis=0)                      # [nPer, T]

    def _batches(self) -> Iterator[dict]:
        epoch_rng = np.random.default_rng(
            (self.seed + self.sampler.epoch) * 7919 + 13)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for batch in self.sampler:
                seeds = epoch_rng.integers(0, 2**31, size=len(batch))
                futures = [pool.submit(self._load_tuple, tup,
                                       np.random.default_rng(int(s)))
                           for tup, s in zip(batch, seeds)]
                waves = np.stack([f.result() for f in futures])
                labels = np.asarray(
                    [self.manifest.labels[t[0]] for t in batch], np.int32)
                yield {"wave": waves, "label": labels}

    def __iter__(self) -> Iterator[dict]:
        """Batches with background prefetch. A consumer that stops early
        stops the producer thread and its pool too."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        errbox = []
        stop = threading.Event()

        def producer():
            try:
                for item in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:          # raised in the consumer
                errbox.append(e)
            finally:
                # the end mark waits for room like any batch: a full queue
                # means a slow consumer, not a gone one (that one sets stop)
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if errbox:
                        raise errbox[0]
                    return
                yield item
        finally:
            stop.set()
            while not q.empty():                # unblock a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def train_data_loader(hparams: Mapping, num_replicas: int = 1,
                      rank: int = 0) -> TrainDataLoader:
    """The training loader of a config (``train_annotation``,
    ``dataloader_options`` with its optional ``shards`` directory,
    ``audio_spec``, ``augment``, ``augment_options``, ``random_chunk``,
    ``seed``)."""
    opts = hparams.get("dataloader_options", {}) or {}
    return TrainDataLoader(
        manifest=Manifest.read(hparams["train_annotation"]),
        shard_source=(ShardedAudioSource(opts["shards"])
                      if opts.get("shards") else None),
        audio_spec=hparams["audio_spec"],
        batch_size=int(opts.get("batch_size", hparams.get("batch_size", 32))),
        nPerSpeaker=int(opts.get("nPerSpeaker", 1)),
        max_seg_per_spk=int(opts.get("max_seg_per_spk", 500)),
        augment=bool(hparams.get("augment", False)),
        augment_options=hparams.get("augment_options"),
        random_chunk=bool(hparams.get("random_chunk", True)),
        num_workers=int(opts.get("num_workers", 8)),
        seed=int(hparams.get("seed", 0)),
        num_replicas=num_replicas, rank=rank)
