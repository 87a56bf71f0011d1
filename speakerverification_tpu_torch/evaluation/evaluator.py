"""Trial evaluation (port of ``evaluate_from_list`` and its helpers from
``evaluation/evaluator.py``): parse a trial file, embed each unique file
once in fixed-shape batches, score the whole list in one pass on the
device.

Trial files hold ``label file1 file2`` lines, comma- or
whitespace-delimited; a first line that does not parse is a header.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from speakerverification_tpu_torch.data.loader import EvalDataLoader
from speakerverification_tpu_torch.evaluation.scoring import score_trials

__all__ = ["sniff_has_label", "parse_trials", "extract_embeddings",
           "evaluate_from_list"]


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
                       batch_size: int = 32,
                       num_workers: int = 8) -> torch.Tensor:
    """Embed unique files in fixed-shape batches → ``[n_files, E, D]``,
    on the device ``embed_fn`` returns its embeddings on (one process;
    multi-GPU extraction is not ported yet)."""
    if not files:
        raise ValueError("extract_embeddings: empty file list "
                         "(empty trial list or speaker directory?)")
    loader = EvalDataLoader(files, audio_spec, num_eval=num_eval,
                            batch_size=batch_size, num_workers=num_workers)
    out = []
    for waves, paths in loader:
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
                       batch_size: int = 32, num_workers: int = 8):
    """Returns ``(scores, labels, trials)``."""
    labels, refs, coms = parse_trials(listfile, with_label=True)
    setfiles = sorted(set(refs) | set(coms))
    index = {f: i for i, f in enumerate(setfiles)}
    emb = extract_embeddings(embed_fn, setfiles, audio_spec, num_eval,
                             batch_size, num_workers)
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
