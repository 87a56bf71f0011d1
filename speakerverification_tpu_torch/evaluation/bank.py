"""Device-resident speaker bank (port of ``evaluation/bank.py``).

Identification over enrolled speakers: on L2-normalized embeddings the
reference's score ``1 − d²/2`` is the cosine, and the nearest speaker
is the argmax of the cosine, so a lookup is one ``[Q, D] @ [D, N]``
product and a top-k. :class:`SpeakerBank` keeps the normalized bank on
one device, in fp32 or bf16 (half the memory; scores still rank in
fp32):

* rows are L2-normalized once and padded to a multiple of
  ``pad_rows_to``; padded rows are masked to −2 (below any cosine)
  before the top-k, against a valid-row count kept as a tensor;
* queries are normalized inside :meth:`~SpeakerBank.identify`, so raw
  or normalized embeddings may be passed;
* batches above the largest of ``query_buckets`` are split into chunks,
  which bounds the ``[Q, N]`` score buffer (the JAX package also pads
  queries to those buckets, so that XLA reuses compiled programs; the
  port needs no padding);
* ties rank as ``lax.top_k`` ranks them: the lower index first.

The product and the top-k are ``torch.matmul`` and ``torch.topk``: the
JAX package computes them outside any Pallas kernel.

:class:`ShardedSpeakerBank` splits the rows over several devices of one
process (equal padded shards; a list may name one device twice, so one
card can hold two shards): each shard scores its rows and keeps its
local top-k, and a global top-k over those candidates gives exactly the
one-device bank's answer, since every global top-k row is in its own
shard's top-k. The ``[Q, N]`` scores never exist whole.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["SpeakerBank", "ShardedSpeakerBank", "identify_with_bank",
           "AUTO_DEVICE_BANK_MIN_ROWS"]

# banks at or above this many rows route /identify and --predict through
# the device product by default; below it a host scan is already fast
AUTO_DEVICE_BANK_MIN_ROWS = 4096


def _normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _as_rows(x, device) -> torch.Tensor:
    """fp32 ``[M, D]`` on ``device`` from numpy or a tensor (1-D is one
    row)."""
    t = torch.as_tensor(x) if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.asarray(x, np.float32))
    t = t.to(device=device, dtype=torch.float32)
    return t.reshape(1, -1) if t.dim() == 1 else t


def topk_lower_index_first(scores: torch.Tensor, k: int):
    """``torch.topk`` over the last axis with ``lax.top_k``'s order:
    descending scores, equal scores by ascending index, and at the k-th
    place the lower-indexed of equal scores. ``torch.topk`` promises no
    order among equal values, so its ``k + 1`` best are reordered by
    index within equal scores. A row whose k-th and (k+1)-th scores tie
    leaves the boundary to the index order: its candidates (every score
    at least its k-th) are listed in index order and stable-sorted by
    score."""
    n = scores.shape[-1]
    vals, idx = torch.topk(scores, min(k + 1, n), dim=-1)
    tie = vals[:, k - 1] == vals[:, k] if k < n else None
    vals, idx = vals[:, :k], idx[:, :k]
    by_index = torch.argsort(idx, dim=-1)
    vals, idx = vals.gather(1, by_index), idx.gather(1, by_index)
    by_score = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    vals, idx = vals.gather(1, by_score), idx.gather(1, by_score)
    if tie is not None and bool(tie.any()):
        kth = torch.where(tie, vals[:, k - 1], torch.inf)
        row, col = (scores >= kth[:, None]).nonzero(as_tuple=True)
        v = scores[row, col]
        # (row, col) come in index order: stable sorts by score, then by
        # row, leave each row's candidates best first, ties by index
        order = torch.sort(v, descending=True, stable=True).indices
        order = order[torch.sort(row[order], stable=True).indices]
        row, col, v = row[order], col[order], v[order]
        count = torch.bincount(row, minlength=len(vals))
        start = torch.cumsum(count, 0) - count
        take = torch.arange(len(row), device=row.device) - start[row] < k
        rows = tie.nonzero().squeeze(1)
        vals[rows] = v[take].reshape(-1, k)
        idx[rows] = col[take].reshape(-1, k)
    return vals, idx


class SpeakerBank:
    """L2-normalized enrollment bank on one device with a product +
    top-k lookup.

    Parameters
    ----------
    embeds : ``[N, D]`` enrolled mean embeddings (numpy or a tensor, on
        any device; normalized or not).
    labels : optional sequence or mapping of N speaker names; ``name(i)``
        falls back to the index when absent.
    dtype : storage dtype, ``torch.float32`` or ``torch.bfloat16``.
    pad_rows_to : rows are padded to a multiple of this.
    query_buckets : the largest is the chunk size of a query batch.
    device : where the bank lives; CUDA unless the caller passes another.
    """

    def __init__(self, embeds, labels: Optional[Sequence | Mapping] = None,
                 *, dtype: torch.dtype = torch.float32,
                 pad_rows_to: int = 1024,
                 query_buckets: Sequence[int] = (1, 8, 64, 512),
                 device=None):
        from speakerverification_tpu_torch.inference import resolve_device
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"bank dtype must be float32 or bfloat16, got "
                             f"{dtype}")
        if isinstance(embeds, torch.Tensor):
            src = embeds
        else:
            src = np.asarray(embeds, np.float32)
        if src.ndim != 2:
            raise ValueError(f"bank must be [N, D], got {tuple(src.shape)}")
        self.n, self.dim = int(src.shape[0]), int(src.shape[1])
        self._pad_unit = int(pad_rows_to)
        self.n_pad = -(-max(self.n, 1) // self._pad_unit) * self._pad_unit
        self._buckets = tuple(sorted({int(b) for b in query_buckets}))
        self._labels = labels
        self._bank = torch.zeros((self.n_pad, self.dim), dtype=dtype,
                                 device=self.device)
        # normalize in slices: no second bank-sized fp32 temporary
        step = max(1, (1 << 26) // max(self.dim, 1))
        for lo in range(0, self.n, step):
            rows = _as_rows(src[lo:lo + step], self.device)
            self._bank[lo:lo + rows.shape[0]] = _normalize_rows(rows).to(dtype)
        self._n_valid = torch.tensor(self.n, device=self.device)
        self._col = torch.arange(self.n_pad, device=self.device)

    @property
    def dtype(self) -> torch.dtype:
        return self._bank.dtype

    @property
    def nbytes(self) -> int:
        return self._bank.numel() * self._bank.element_size()

    def name(self, idx: int):
        if self._labels is None:
            return int(idx)
        return self._labels[int(idx)]

    def identify(self, queries, k: int = 1):
        """Top-k speakers by cosine (the reference's ``1 − d²/2``).

        ``queries``: ``[Q, D]`` or ``[D]``. Returns ``(scores [Q, k] fp32,
        idx [Q, k] int64)`` as numpy arrays."""
        q = _as_rows(queries, self.device)
        if q.shape[-1] != self.dim:
            raise ValueError(f"query dim {q.shape[-1]} != bank {self.dim}")
        k = min(int(k), self.n)
        if k == 0:                                 # empty bank
            return (np.zeros((q.shape[0], 0), np.float32),
                    np.zeros((q.shape[0], 0), np.int64))
        out_s, out_i = [], []
        valid = self._col < self._n_valid
        for lo in range(0, q.shape[0], self._buckets[-1]):
            qn = _normalize_rows(q[lo:lo + self._buckets[-1]])
            # ranked in the storage dtype (bf16 values widen to fp32
            # exactly and in order), returned in fp32
            scores = qn.to(self._bank.dtype) @ self._bank.T
            scores.masked_fill_(~valid, -2.0)
            s, i = topk_lower_index_first(scores, k)
            out_s.append(s.float())
            out_i.append(i)
        return (torch.cat(out_s).cpu().numpy(),
                torch.cat(out_i).cpu().numpy())

    # ------------------------------------------------------- enrollment
    def _append_labels(self, names) -> None:
        if names is None:
            if self._labels is not None:
                raise ValueError("bank has labels; add() needs names")
            return
        if self._labels is None and self.n > 0:
            raise ValueError("bank has no labels; add() got names")
        if self._labels is None:
            self._labels = {}
        if isinstance(self._labels, Mapping):
            if not isinstance(self._labels, dict):
                self._labels = dict(self._labels)
            for j, nm in enumerate(names):
                self._labels[self.n + j] = nm
        else:
            self._labels = list(self._labels) + list(names)

    def _grow(self, min_rows: int) -> None:
        """Re-pad so that at least ``min_rows`` fit (old and new bank
        coexist for the copy)."""
        new_pad = -(-min_rows // self._pad_unit) * self._pad_unit
        bank = torch.zeros((new_pad, self.dim), dtype=self._bank.dtype,
                           device=self.device)
        bank[:self.n_pad] = self._bank
        self._bank, self.n_pad = bank, new_pad
        self._col = torch.arange(self.n_pad, device=self.device)

    def add(self, embeds, names: Optional[Sequence] = None) -> np.ndarray:
        """Enroll rows into the live bank in place (``index_copy_``),
        re-padding past capacity. Returns the new rows' indices."""
        rows = _normalize_rows(_as_rows(embeds, self.device))
        if rows.shape[-1] != self.dim:
            raise ValueError(f"embed dim {rows.shape[-1]} != {self.dim}")
        m = rows.shape[0]
        if names is not None and len(names) != m:
            raise ValueError(f"{m} rows but {len(names)} names")
        if m == 0:
            return np.zeros((0,), np.int64)
        if self.n + m > self.n_pad:
            self._grow(self.n + m)
        self._append_labels(names)
        idx = torch.arange(self.n, self.n + m, device=self.device)
        self._bank.index_copy_(0, idx, rows.to(self._bank.dtype))
        self.n += m
        self._n_valid.fill_(self.n)
        return idx.cpu().numpy()

    def remove(self, idx: int):
        """Un-enroll row ``idx``: the last valid row moves into its slot
        and the valid count shrinks. Returns ``idx`` when a row moved into
        it, None when ``idx`` was the last row."""
        idx = int(idx)
        if not 0 <= idx < self.n:
            raise IndexError(f"row {idx} not in bank of {self.n}")
        last = self.n - 1
        moved = None
        if idx != last:
            self._move_row(last, idx)
            moved = idx
        if self._labels is not None:
            if isinstance(self._labels, Mapping):
                if not isinstance(self._labels, dict):
                    self._labels = dict(self._labels)
                if idx != last:
                    self._labels[idx] = self._labels[last]
                self._labels.pop(last, None)
            else:
                self._labels = list(self._labels)
                if idx != last:
                    self._labels[idx] = self._labels[last]
                del self._labels[last]
        self.n = last
        self._n_valid.fill_(self.n)
        return moved

    def _move_row(self, src: int, dst: int) -> None:
        self._bank[dst] = self._bank[src]


class ShardedSpeakerBank(SpeakerBank):
    """:class:`SpeakerBank` with its rows split over ``devices``, in one
    process: shard i holds rows ``[i·R, (i+1)·R)`` of the padded bank on
    ``devices[i]`` (R = ``n_pad / len(devices)``, a multiple of
    ``pad_rows_to``), so the bank may be as large as the cards' memory
    together. ``identify`` equals :meth:`SpeakerBank.identify`; results
    come back on the first device. Enrollment (``add``, ``remove``)
    keeps the row layout, and growth re-pads every shard equally."""

    def __init__(self, embeds, labels: Optional[Sequence | Mapping] = None,
                 *, devices: Sequence, dtype: torch.dtype = torch.float32,
                 pad_rows_to: int = 1024,
                 query_buckets: Sequence[int] = (1, 8, 64, 512)):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedSpeakerBank needs at least one device")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"bank dtype must be float32 or bfloat16, got "
                             f"{dtype}")
        self.device = self.devices[0]
        self.n_dev = len(self.devices)
        src = embeds if isinstance(embeds, torch.Tensor) \
            else np.asarray(embeds, np.float32)
        if src.ndim != 2:
            raise ValueError(f"bank must be [N, D], got {tuple(src.shape)}")
        self.n, self.dim = int(src.shape[0]), int(src.shape[1])
        self._pad_unit = int(pad_rows_to) * self.n_dev
        self.n_pad = -(-max(self.n, 1) // self._pad_unit) * self._pad_unit
        self.shard_rows = self.n_pad // self.n_dev
        self._buckets = tuple(sorted({int(b) for b in query_buckets}))
        self._labels = labels
        self._shards = [torch.zeros((self.shard_rows, self.dim), dtype=dtype,
                                    device=d) for d in self.devices]
        # the valid-row count, as SpeakerBank keeps it (identify masks by
        # self.n)
        self._n_valid = torch.tensor(self.n)
        # each shard normalizes its own rows, in slices
        step = max(1, (1 << 26) // max(self.dim, 1))
        for lo in range(0, self.n, step):
            rows = src[lo:lo + step]
            self._write_rows(lo, rows)

    @property
    def dtype(self) -> torch.dtype:
        return self._shards[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._shards)

    def _write_rows(self, lo: int, rows) -> None:
        """Normalized ``rows`` into the global rows ``lo...``, shard by
        shard."""
        m = int(rows.shape[0])
        for i, shard in enumerate(self._shards):
            a = max(lo, i * self.shard_rows)
            b = min(lo + m, (i + 1) * self.shard_rows)
            if a < b:
                part = _normalize_rows(_as_rows(rows[a - lo:b - lo],
                                                shard.device))
                shard[a - i * self.shard_rows:b - i * self.shard_rows] = \
                    part.to(shard.dtype)

    def identify(self, queries, k: int = 1):
        """:meth:`SpeakerBank.identify`, shard by shard: each shard's
        top ``min(k, R)`` with global row indices, then the top k of
        those (candidates in shard order, so equal scores still rank by
        the lower index)."""
        q = _as_rows(queries, self.device)
        if q.shape[-1] != self.dim:
            raise ValueError(f"query dim {q.shape[-1]} != bank {self.dim}")
        k = min(int(k), self.n)
        if k == 0:
            return (np.zeros((q.shape[0], 0), np.float32),
                    np.zeros((q.shape[0], 0), np.int64))
        k_local = min(k, self.shard_rows)
        out_s, out_i = [], []
        for lo in range(0, q.shape[0], self._buckets[-1]):
            chunk = q[lo:lo + self._buckets[-1]]
            cand_s, cand_i = [], []
            for i, shard in enumerate(self._shards):
                row0 = i * self.shard_rows
                qn = _normalize_rows(chunk.to(shard.device))
                scores = qn.to(shard.dtype) @ shard.T
                n_valid = min(max(self.n - row0, 0), self.shard_rows)
                scores[:, n_valid:] = -2.0
                s, li = topk_lower_index_first(scores, k_local)
                cand_s.append(s.float().to(self.device))
                cand_i.append((li + row0).to(self.device))
            gs, pos = topk_lower_index_first(torch.cat(cand_s, 1), k)
            out_s.append(gs)
            out_i.append(torch.cat(cand_i, 1).gather(1, pos))
        return (torch.cat(out_s).cpu().numpy(),
                torch.cat(out_i).cpu().numpy())

    def _grow(self, min_rows: int) -> None:
        """Re-pad to equal shards of at least ``min_rows`` rows in all
        (a multiple of ``pad_rows_to`` × devices); rows keep their
        global indices, so some move to the next shard."""
        new_pad = -(-min_rows // self._pad_unit) * self._pad_unit
        rows = new_pad // self.n_dev
        new = [torch.zeros((rows, self.dim), dtype=self.dtype, device=d)
               for d in self.devices]
        for i, old in enumerate(self._shards):
            o_lo = i * self.shard_rows
            for j, dst in enumerate(new):
                a = max(o_lo, j * rows)
                b = min(o_lo + self.shard_rows, (j + 1) * rows, self.n)
                if a < b:
                    dst[a - j * rows:b - j * rows] = \
                        old[a - o_lo:b - o_lo].to(dst.device)
        self._shards, self.n_pad, self.shard_rows = new, new_pad, rows

    def _row(self, i: int) -> torch.Tensor:
        return self._shards[i // self.shard_rows][i % self.shard_rows]

    def add(self, embeds, names: Optional[Sequence] = None) -> np.ndarray:
        """Enroll rows at the end of the bank (re-padding past
        capacity); returns their indices."""
        rows = _as_rows(embeds, self.device)
        if rows.shape[-1] != self.dim:
            raise ValueError(f"embed dim {rows.shape[-1]} != {self.dim}")
        m = rows.shape[0]
        if names is not None and len(names) != m:
            raise ValueError(f"{m} rows but {len(names)} names")
        if m == 0:
            return np.zeros((0,), np.int64)
        if self.n + m > self.n_pad:
            self._grow(self.n + m)
        self._append_labels(names)
        self._write_rows(self.n, rows)
        self.n += m
        self._n_valid.fill_(self.n)
        return np.arange(self.n - m, self.n, dtype=np.int64)

    def _move_row(self, src: int, dst: int) -> None:
        row = self._row(dst)
        row.copy_(self._row(src).to(row.device))


def identify_with_bank(bank: SpeakerBank, queries, threshold: float = 0.0):
    """The reference's ``--predict`` over a bank: the best speaker per
    query, ``'unknown'`` below ``threshold``."""
    if bank.n == 0:
        raise ValueError("bank has no enrolled speakers")
    scores, idx = bank.identify(queries, k=1)
    scores, idx = scores[:, 0], idx[:, 0]
    names = [bank.name(int(b)) if scores[i] >= threshold else "unknown"
             for i, b in enumerate(idx)]
    return names, scores
