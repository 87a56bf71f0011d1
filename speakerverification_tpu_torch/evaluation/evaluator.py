"""Trial evaluation, cohort and enrollment preparation, decision runs
and identification (port of ``evaluation/evaluator.py``).

* ``evaluate_from_list`` — parse a trial file, embed each unique file
  once in fixed-shape batches, score the whole list in one pass on the
  device;
* ``prepare_cohorts`` — up to 3 utterances per speaker of the train
  manifest → normalized crop embeddings → per-speaker mean → cohort bank;
* ``prepare_embeddings`` — per-speaker mean embeddings and the class map
  for identification;
* ``test_from_list`` — scores and decisions at a threshold;
* ``predict_identity`` — the nearest enrolled speaker, score 1 − d²/2.

Trial files hold ``label file1 file2`` lines, comma- or
whitespace-delimited; a first line that does not parse is a header.
"""

from __future__ import annotations

import contextlib
import csv
from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from speakerverification_tpu_torch.data.loader import EvalDataLoader
from speakerverification_tpu_torch.evaluation.bank import (
    AUTO_DEVICE_BANK_MIN_ROWS,
    SpeakerBank,
    identify_with_bank,
)
from speakerverification_tpu_torch.evaluation.scoring import (
    l2_normalize,
    score_trials,
)
from speakerverification_tpu_torch.parallel.multihost import (
    is_multiprocess,
    process_allgather,
)
from speakerverification_tpu_torch.utils import tracing

__all__ = ["sniff_has_label", "parse_trials", "extract_embeddings",
           "evaluate_from_list", "prepare_cohorts", "prepare_embeddings",
           "test_from_list", "predict_identity"]


def sniff_has_label(listfile: str | Path) -> bool:
    """Whether the first or second line starts with an integer label (a
    header line must not flip the file to unlabeled; ``int()`` keeps
    negative labels labeled)."""
    with open(listfile) as f:
        head = [ln.strip() for ln in f if ln.strip()][:2]
    for ln in head:
        tok = ln.split("," if "," in ln else None)[0].strip()
        try:
            int(tok)
            return True
        except ValueError:
            continue
    return False


def parse_trials(listfile: str | Path, with_label: bool = True):
    """Trial lines → ``(labels, ref_files, com_files)``. Each line is
    validated whole before anything is appended, so a bad line cannot
    desynchronize labels from pairs; a first line that does not parse
    is skipped as a header, any later one raises ``ValueError``."""
    labels, refs, coms = [], [], []
    want = 3 if with_label else 2
    with open(listfile) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for i, line in enumerate(lines):
        parts = [p.strip() for p in line.split("," if "," in line else None)]
        try:
            if len(parts) != want:
                raise ValueError(f"expected {want} fields, got {len(parts)}")
            lab = int(parts[0]) if with_label else None
        except ValueError as e:
            if i == 0:
                continue                                  # header line
            raise ValueError(f"bad trial line {i}: {line!r} ({e})") from None
        refs.append(parts[-2])
        coms.append(parts[-1])
        if with_label:
            labels.append(lab)
    return np.asarray(labels), refs, coms


def extract_embeddings(embed_fn: Callable, files: Sequence[str],
                       audio_spec: Mapping, num_eval: int = 10,
                       batch_size: int = 32, num_workers: int = 8,
                       distributed: bool = False) -> torch.Tensor:
    """Embed unique files in fixed-shape batches → ``[n_files, E, D]``,
    on the device ``embed_fn`` returns its embeddings on.

    ``distributed=True`` with several processes (every rank calls it):
    each rank embeds a contiguous slice of the file list, padded with
    the last file to equal slices, and ``process_allgather`` puts the
    slices back in file order on every rank (the reference's eval
    ``DistributedSampler`` and ``all_gather_object``)."""
    if not files:
        # here, not in the padding below, where it would leave the other
        # ranks waiting in the gather
        raise ValueError("extract_embeddings: empty file list "
                         "(empty trial list or speaker directory?)")
    if distributed and is_multiprocess():
        world, rank = dist.get_world_size(), dist.get_rank()
        per = -(-len(files) // world)
        padded = list(files) + [files[-1]] * (per * world - len(files))
        local = extract_embeddings(embed_fn, padded[rank * per:
                                                    (rank + 1) * per],
                                   audio_spec, num_eval, batch_size,
                                   num_workers)
        gathered = process_allgather(local)
        out = torch.from_numpy(gathered.reshape(-1, *gathered.shape[2:]))
        return out[:len(files)].to(local.device)
    loader = EvalDataLoader(files, audio_spec, num_eval=num_eval,
                            batch_size=batch_size, num_workers=num_workers)
    out = []
    with contextlib.closing(iter(loader)) as batches:
        for index in range(len(loader)):
            # the wait for the loader's next batch, a loader.wait span
            # while a profiler runs
            with tracing.span("loader.wait", batch=index):
                waves, paths = next(batches)
            B, E, T = waves.shape
            emb = torch.as_tensor(embed_fn(waves.reshape(B * E, T)))
            # drop the rows the loader padded to keep the batch shape fixed
            out.append(emb.reshape(B, E, -1)[:len(paths)])
    return torch.cat(out, dim=0)


def evaluate_from_list(embed_fn: Callable, listfile: str | Path,
                       audio_spec: Mapping, num_eval: int = 10,
                       scoring_mode: Optional[str] = "cosine",
                       cohorts: Optional[np.ndarray] = None,
                       top: int = 200, normalize: bool = True,
                       batch_size: int = 32, num_workers: int = 8,
                       distributed: bool = False):
    """Returns ``(scores, labels, trials)``."""
    labels, refs, coms = parse_trials(listfile, with_label=True)
    setfiles = sorted(set(refs) | set(coms))
    index = {f: i for i, f in enumerate(setfiles)}
    emb = extract_embeddings(embed_fn, setfiles, audio_spec, num_eval,
                             batch_size, num_workers,
                             distributed=distributed)
    ridx = np.asarray([index[f] for f in refs], np.int64)
    cidx = np.asarray([index[f] for f in coms], np.int64)

    if scoring_mode in ("norm", "zt_norm") and cohorts is None:
        raise ValueError("scoring_mode='norm' requires a cohort bank "
                         "(run prepare_cohorts first)")
    # the reference scores by -distance whenever no cohorts are given;
    # an explicit cosine/pnorm request is honoured without cohorts, and
    # only an unset or other mode falls back to -distance
    mode = scoring_mode if cohorts is not None or scoring_mode in (
        "cosine", "pnorm") else "distance"
    scores = score_trials(emb, ridx, cidx, mode=mode, cohorts=cohorts,
                          top=top, normalize=normalize)
    trials = [f"{r} {c}" for r, c in zip(refs, coms)]
    return scores, labels, trials


def _normalized(emb: torch.Tensor) -> np.ndarray:
    """Crop embeddings L2-normalized on their device, as numpy."""
    return l2_normalize(emb.float()).cpu().numpy()


def _normalize_np(x: np.ndarray) -> np.ndarray:
    return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12,
                       None)


def _read_manifest_pairs(source: str | Path):
    """``(speaker, path)`` pairs of a CSV manifest (with a header) or a
    space-delimited list."""
    pairs = []
    with open(source, newline="") as f:
        sample = f.read(4096)
        f.seek(0)
        if "," in sample.splitlines()[0]:
            reader = csv.reader(f)
            next(reader, None)
            for row in reader:
                if len(row) >= 2:
                    pairs.append((row[0], row[1]))
        else:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    pairs.append((parts[0], parts[1]))
    return pairs


def prepare_cohorts(embed_fn: Callable, source: str | Path,
                    audio_spec: Mapping, num_eval: int = 10,
                    n_emb_per_spk: int = 3, save_path: Optional[str] = None,
                    batch_size: int = 32, num_workers: int = 8) -> np.ndarray:
    """Cohort bank ``[n_speakers, D]``: per speaker, the mean of the
    normalized crop embeddings of its first ``n_emb_per_spk`` files."""
    by_spk: dict[str, list[str]] = {}
    for spk, path in _read_manifest_pairs(source):
        by_spk.setdefault(spk, []).append(path)
    files, owner = [], []
    for spk, paths in by_spk.items():
        for p in paths[:n_emb_per_spk]:
            files.append(p)
            owner.append(spk)
    emb = _normalized(extract_embeddings(embed_fn, files, audio_spec,
                                         num_eval, batch_size, num_workers))
    cohort = np.stack([
        emb[[i for i, o in enumerate(owner) if o == spk]]
        .reshape(-1, emb.shape[-1]).mean(0) for spk in by_spk])
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        np.save(save_path, cohort)
    return cohort


def prepare_embeddings(embed_fn: Callable, source: str | Path,
                       audio_spec: Mapping, num_eval: int = 10,
                       save_dir: Optional[str] = None, normalize: bool = True,
                       batch_size: int = 32, num_workers: int = 8):
    """Enrollment bank from ``source/<speaker>/*.wav``: ``(embeds
    [n_speakers, D], classes {index: name})``, saved as ``embeds.npy``
    and ``classes.npy`` under ``save_dir``."""
    speaker_dirs = sorted(p for p in Path(source).iterdir() if p.is_dir())
    classes = {i: d.stem for i, d in enumerate(speaker_dirs)}
    means = []
    for d in speaker_dirs:
        files = sorted(str(f) for f in d.glob("*.wav"))
        emb = extract_embeddings(embed_fn, files, audio_spec, num_eval,
                                 batch_size, num_workers)
        emb = _normalized(emb) if normalize else emb.float().cpu().numpy()
        means.append(emb.reshape(-1, emb.shape[-1]).mean(0))
    embeds = np.stack(means)
    if save_dir:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        np.save(Path(save_dir) / "embeds.npy", embeds)
        np.save(Path(save_dir) / "classes.npy", classes)
    return embeds, classes


def test_from_list(embed_fn: Callable, listfile: str | Path,
                   audio_spec: Mapping, threshold: float,
                   num_eval: int = 10, scoring_mode: str = "cosine",
                   cohorts: Optional[np.ndarray] = None, top: int = 200,
                   normalize: bool = True, output_file: Optional[str] = None,
                   batch_size: int = 32, num_workers: int = 8):
    """Decision run: ``(scores, preds, labels)`` at ``threshold``;
    ``labels`` is None for an unlabeled list. ``output_file`` gets one
    ``pred score file1 file2`` line per trial."""
    if sniff_has_label(listfile):
        labels, refs, coms = parse_trials(listfile, with_label=True)
    else:
        _, refs, coms = parse_trials(listfile, with_label=False)
        labels = None
    setfiles = sorted(set(refs) | set(coms))
    index = {f: i for i, f in enumerate(setfiles)}
    emb = extract_embeddings(embed_fn, setfiles, audio_spec, num_eval,
                             batch_size, num_workers)
    ridx = np.asarray([index[f] for f in refs], np.int64)
    cidx = np.asarray([index[f] for f in coms], np.int64)
    scores = score_trials(emb, ridx, cidx, mode=scoring_mode,
                          cohorts=cohorts, top=top, normalize=normalize)
    preds = (scores >= threshold).astype(int)
    if output_file:
        Path(output_file).parent.mkdir(parents=True, exist_ok=True)
        with open(output_file, "w") as f:
            for r, c, s, p in zip(refs, coms, scores, preds):
                f.write(f"{p} {s:.6f} {r} {c}\n")
    return scores, preds, labels


def predict_identity(embed_fn: Callable, files: Sequence[str],
                     enrolled: np.ndarray, classes: Mapping,
                     audio_spec: Mapping, num_eval: int = 10,
                     threshold: float = 0.0, batch_size: int = 32,
                     num_workers: int = 8,
                     device_bank: Optional[bool] = None):
    """The nearest enrolled speaker of each file; score ``1 − d²/2`` on
    normalized means. Returns ``(names, scores)``; below ``threshold``
    the name is ``'unknown'``.

    ``device_bank`` routes the scan through a :class:`SpeakerBank` on
    the embeddings' device (None: for banks of at least
    ``AUTO_DEVICE_BANK_MIN_ROWS`` rows); on normalized vectors its cosine
    equals the host scan's score to fp32 rounding."""
    emb = extract_embeddings(embed_fn, list(files), audio_spec, num_eval,
                             batch_size, num_workers)
    device = emb.device
    emb = _normalize_np(_normalized(emb).mean(axis=1))            # [n, D]
    enr = _normalize_np(np.asarray(enrolled, np.float32))
    if device_bank is None:
        device_bank = len(enr) >= AUTO_DEVICE_BANK_MIN_ROWS
    if device_bank:
        bank = SpeakerBank(enr, classes, device=device)
        return identify_with_bank(bank, emb, threshold=threshold)
    d2 = (np.sum(emb ** 2, -1)[:, None] + np.sum(enr ** 2, -1)[None, :]
          - 2.0 * emb @ enr.T)
    best = np.argmin(d2, axis=-1)
    scores = 1.0 - d2[np.arange(len(best)), best] / 2.0
    names = [classes[int(b)] if scores[i] >= threshold else "unknown"
             for i, b in enumerate(best)]
    return names, scores
