"""False-accept / false-reject pair dumps written after evaluation (port
of ``dump_fa_fr_pairs`` from ``evaluation/reports.py``; the decision-run
reports come with ``--test``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["dump_fa_fr_pairs"]


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
