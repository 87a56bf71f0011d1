"""Decision-run reports: a decisions file against the truth, the
false-accept / false-reject pair dumps, the classification report and
F-beta (port of ``evaluation/reports.py``: ``evaluate_result``,
``fbeta_score``, ``classification_report`` and ``dump_fa_fr_pairs``;
pure numpy, the report text the same character for character)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["classification_report", "fbeta_score", "evaluate_result",
           "dump_fa_fr_pairs"]


def _counts(y_true, y_pred, cls):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tp = int(np.sum((y_pred == cls) & (y_true == cls)))
    fp = int(np.sum((y_pred == cls) & (y_true != cls)))
    fn = int(np.sum((y_pred != cls) & (y_true == cls)))
    return tp, fp, fn


def fbeta_score(y_true, y_pred, beta: float = 1.0, pos_label: int = 1,
                ) -> float:
    tp, fp, fn = _counts(y_true, y_pred, pos_label)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    if precision == recall == 0.0:
        return 0.0
    b2 = beta * beta
    return (1 + b2) * precision * recall / (b2 * precision + recall)


def classification_report(y_true, y_pred,
                          target_names: Optional[Sequence[str]] = None,
                          digits: int = 5) -> str:
    """sklearn-format per-class precision/recall/f1 report; a class is
    named by its value (``target_names[value]``), so a class absent from
    the data shifts no name."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    classes = sorted(set(y_true.tolist()) | set(y_pred.tolist()))
    if target_names is not None:
        names = [target_names[c] if isinstance(c, (int, np.integer))
                 and 0 <= c < len(target_names) else str(c)
                 for c in classes]
    else:
        names = [str(c) for c in classes]
    rows = []
    for c, name in zip(classes, names):
        tp, fp, fn = _counts(y_true, y_pred, c)
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        rows.append((name, p, r, f1, int(np.sum(y_true == c))))
    w = max(len(n) for n, *_ in rows) + 2
    lines = [f"{'':<{w}}{'precision':>10}{'recall':>10}{'f1-score':>10}"
             f"{'support':>10}"]
    for name, p, r, f1, sup in rows:
        lines.append(f"{name:<{w}}{p:>10.{digits}f}{r:>10.{digits}f}"
                     f"{f1:>10.{digits}f}{sup:>10}")
    acc = float(np.mean(y_true == y_pred))
    lines.append("")
    lines.append(f"{'accuracy':<{w}}{'':>20}{acc:>10.{digits}f}"
                 f"{len(y_true):>10}")
    return "\n".join(lines)


def _read_pairs(path, as_truth: bool) -> dict:
    """``{(file1, file2): label}`` of a truth file (``label file1
    file2``) or a decisions file: the port's ``pred score file1 file2``
    or the reference's CSV ``file1,file2,pred``. A header line is
    skipped."""
    data = {}
    with open(path, newline="") as f:
        first = f.readline()
        delim = "," if "," in first else " "
        f.seek(0)
        for row in csv.reader(f, delimiter=delim):
            row = [r for r in row if r != ""]
            if len(row) < 3:
                continue
            try:
                if as_truth:
                    data[(row[-2], row[-1])] = int(row[0])
                elif row[0].isdigit() and len(row) >= 4:
                    data[(row[-2], row[-1])] = int(row[0])
                else:
                    data[(row[0], row[1])] = int(row[2])
            except ValueError:
                continue
    return data


def evaluate_result(com_path: str | Path, ref_path: str | Path,
                    beta_values: Sequence[float] = (0.5, 2),
                    save_cm: Optional[str | Path] = None) -> dict:
    """Compare a decisions file with a truth file (src/inference.py:330-408).

    Pairs are matched by their ``(file1, file2)`` key. Returns the pair
    counts, accuracy, TPR/FNR/FPR/TNR, the classification report and
    F-beta at each ``beta_values``; ``save_cm`` writes the confusion
    matrix there (``utils.plotting``, which needs matplotlib)."""
    ref = _read_pairs(ref_path, as_truth=True)
    com = _read_pairs(com_path, as_truth=False)
    keys = [k for k in ref if k in com]
    if not keys:
        raise ValueError("no matching trial pairs between files")
    y_true = [ref[k] for k in keys]
    y_pred = [com[k] for k in keys]

    tp, fp, fn = _counts(y_true, y_pred, 1)
    tn = len(keys) - tp - fp - fn
    tpr = tp / (tp + fn) if tp + fn else 0.0
    fpr = fp / (fp + tn) if fp + tn else 0.0
    report = {
        "n_pairs": len(keys),
        "n_matched": len(keys),
        "n_unmatched": len(ref) - len(keys),
        "accuracy": float(np.mean(np.asarray(y_true) == np.asarray(y_pred))),
        "tpr": tpr, "fnr": 1 - tpr, "fpr": fpr, "tnr": 1 - fpr,
        "classification_report": classification_report(
            y_true, y_pred, ["Label '0'", "Label '1'"]),
        "fbeta": {b: fbeta_score(y_true, y_pred, b) for b in beta_values},
    }
    if save_cm:
        from speakerverification_tpu_torch.utils.plotting import (
            plot_confusion_matrix,
        )
        plot_confusion_matrix(y_true, y_pred, save_cm)
    return report


def dump_fa_fr_pairs(scores, labels, trials, threshold: float,
                     out_dir: str | Path) -> dict:
    """Write ``false_accept_pairs.txt`` (highest score first) and
    ``false_reject_pairs.txt`` (lowest first) at ``threshold``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    preds = (scores >= threshold).astype(int)

    fa = [(s, t) for s, l, p, t in zip(scores, labels, preds, trials)
          if p == 1 and l == 0]
    fr = [(s, t) for s, l, p, t in zip(scores, labels, preds, trials)
          if p == 0 and l == 1]
    with open(out_dir / "false_accept_pairs.txt", "w") as f:
        for s, t in sorted(fa, reverse=True):
            f.write(f"{s:.6f} {t}\n")
    with open(out_dir / "false_reject_pairs.txt", "w") as f:
        for s, t in sorted(fr):
            f.write(f"{s:.6f} {t}\n")
    return {"n_false_accept": len(fa), "n_false_reject": len(fr),
            "fa_file": str(out_dir / "false_accept_pairs.txt"),
            "fr_file": str(out_dir / "false_reject_pairs.txt")}
