"""Dataset quality control (port of ``data/quality.py``): per-file
duration, dBFS and clipping from the decoded samples, dataset summaries,
blacklists, and a mover that quarantines files below the thresholds.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from speakerverification_tpu_torch.data.wavio import read_wav

__all__ = ["audio_stats", "dataset_statistics", "read_blacklist",
           "filter_low_quality"]


def audio_stats(path: str | Path) -> dict:
    """Duration, dBFS (RMS and peak) and the clipped share of one file; an
    empty file reports as silence, so that the filter quarantines it."""
    audio, sr = read_wav(path)
    if audio.size == 0:
        return {"path": str(path), "duration": 0.0, "sample_rate": sr,
                "rms_dbfs": -240.0, "peak_dbfs": -240.0, "clip_ratio": 0.0}
    rms = float(np.sqrt(np.mean(audio ** 2) + 1e-12))
    peak = float(np.max(np.abs(audio)) + 1e-12)
    return {
        "path": str(path),
        "duration": len(audio) / sr,
        "sample_rate": sr,
        "rms_dbfs": 20 * np.log10(rms),
        "peak_dbfs": 20 * np.log10(peak),
        "clip_ratio": float(np.mean(np.abs(audio) > 0.999)),
    }


def dataset_statistics(root: str | Path, limit: Optional[int] = None,
                       save_json: Optional[str | Path] = None) -> dict:
    """Totals over every ``*.wav`` under ``root`` (sorted; the first
    ``limit``), with each file's row under ``files``."""
    files = sorted(Path(root).rglob("*.wav"))
    if limit:
        files = files[:limit]
    rows = [audio_stats(f) for f in files]
    durations = np.array([r["duration"] for r in rows]) if rows else np.zeros(0)
    dbfs = np.array([r["rms_dbfs"] for r in rows]) if rows else np.zeros(0)
    summary = {
        "n_files": len(rows),
        "total_hours": float(durations.sum() / 3600) if rows else 0.0,
        "duration_mean": float(durations.mean()) if rows else 0.0,
        "duration_min": float(durations.min()) if rows else 0.0,
        "duration_max": float(durations.max()) if rows else 0.0,
        "dbfs_mean": float(dbfs.mean()) if rows else 0.0,
        "files": rows,
    }
    if save_json:
        Path(save_json).write_text(json.dumps(summary, indent=2))
    return summary


def read_blacklist(path: str | Path) -> set:
    """One path per line (its first field); ``#`` starts a comment line; a
    missing file is an empty list."""
    out = set()
    p = Path(path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line.split()[0])
    return out


def filter_low_quality(root: str | Path, quarantine: str | Path,
                       min_duration: float = 0.5,
                       min_dbfs: float = -50.0,
                       max_clip_ratio: float = 0.2,
                       blacklist: Optional[Iterable[str]] = None,
                       dry_run: bool = False) -> dict:
    """Move the files that are blacklisted or fail a threshold into
    ``quarantine`` (their path under ``root`` kept)."""
    blacklist = set(blacklist or ())
    root = Path(root)
    quarantine = Path(quarantine)
    moved, kept = [], 0
    for f in sorted(root.rglob("*.wav")):
        bad = str(f) in blacklist
        if not bad:
            s = audio_stats(f)
            bad = (s["duration"] < min_duration or s["rms_dbfs"] < min_dbfs
                   or s["clip_ratio"] > max_clip_ratio)
        if bad:
            moved.append(str(f))
            if not dry_run:
                dst = quarantine / f.relative_to(root)
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.move(str(f), dst)
        else:
            kept += 1
    return {"moved": moved, "n_moved": len(moved), "n_kept": kept}
