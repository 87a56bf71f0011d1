"""Decision-run reports and the false-accept / false-reject pair dumps
(port of ``fbeta_score``, ``classification_report`` and
``dump_fa_fr_pairs`` from ``evaluation/reports.py``; pure numpy, the
report text the same character for character). ``evaluate_result`` is
not ported yet."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["classification_report", "fbeta_score", "dump_fa_fr_pairs"]


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
