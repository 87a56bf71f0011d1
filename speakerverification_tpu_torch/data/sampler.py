"""Speaker-balanced batch sampler (port of ``data/sampler.py``; the same
numpy draws, so the same manifest and seed give the same batches).

1. permute all utterance indices with seed = base_seed + epoch;
2. group per speaker into ``nPerSpeaker``-tuples, capped at
   ``max_seg_per_spk`` (rounded down to a tuple multiple);
3. shuffle tuples, then greedily forbid the same speaker appearing twice
   within one batch;
4. round the tuple count down to a batch multiple and statically shard a
   contiguous range per data-parallel rank.

Every epoch yields batches of exactly ``batch_size`` tuples.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

__all__ = ["SpeakerBatchSampler", "round_down"]


def round_down(num: int, divisor: int) -> int:
    return num - (num % divisor)


class SpeakerBatchSampler:
    def __init__(self, labels: Sequence[int], batch_size: int,
                 nPerSpeaker: int = 1, max_seg_per_spk: int = 500,
                 seed: int = 0, num_replicas: int = 1, rank: int = 0):
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.n_per_speaker = nPerSpeaker
        self.max_seg_per_spk = round_down(max_seg_per_spk, nPerSpeaker) \
            or nPerSpeaker
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _tuples(self, rng: np.random.Generator):
        indices = rng.permutation(len(self.labels))
        data_dict: dict[int, list[int]] = {}
        for idx in indices:
            data_dict.setdefault(int(self.labels[idx]), []).append(int(idx))

        tuples: List[List[int]] = []
        tuple_label: List[int] = []
        for findex, key in enumerate(sorted(data_dict)):
            data = data_dict[key]
            num_seg = round_down(min(len(data), self.max_seg_per_spk),
                                 self.n_per_speaker)
            for i in range(0, num_seg, self.n_per_speaker):
                tuples.append(data[i:i + self.n_per_speaker])
                tuple_label.append(findex)
        return tuples, tuple_label

    def __iter__(self) -> Iterator[List[List[int]]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        tuples, tuple_label = self._tuples(rng)

        # shuffle tuples, then forbid same speaker twice per batch
        mixid = rng.permutation(len(tuples))
        mixlabel: List[int] = []
        mixmap: List[int] = []
        for ii in mixid:
            startbatch = round_down(len(mixlabel), self.batch_size)
            if tuple_label[ii] not in mixlabel[startbatch:]:
                mixlabel.append(tuple_label[ii])
                mixmap.append(int(ii))
        mixed = [tuples[i] for i in mixmap]

        # a static contiguous shard per rank
        total = round_down(len(mixed), self.batch_size * self.num_replicas)
        start = self.rank * total // self.num_replicas
        end = (self.rank + 1) * total // self.num_replicas
        shard = mixed[start:end]

        for b in range(0, len(shard), self.batch_size):
            yield shard[b:b + self.batch_size]

    def __len__(self) -> int:
        """Number of batches this rank yields for the current epoch."""
        rng = np.random.default_rng(self.seed + self.epoch)
        tuples, tuple_label = self._tuples(rng)
        mixid = rng.permutation(len(tuples))
        mixlabel: List[int] = []
        for ii in mixid:
            startbatch = round_down(len(mixlabel), self.batch_size)
            if tuple_label[ii] not in mixlabel[startbatch:]:
                mixlabel.append(tuple_label[ii])
        total = round_down(len(mixlabel), self.batch_size * self.num_replicas)
        return total // self.num_replicas // self.batch_size
