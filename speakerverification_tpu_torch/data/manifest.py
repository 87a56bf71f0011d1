"""Training manifests (``train.csv``) and metadata generation (port of
``data/manifest.py``).

A CSV with a header whose rows are ``speaker_id,path,duration,
audio_format``. Speaker labels are the sorted unique speaker ids mapped
to contiguous integers. Durations come from the WAV headers
(``data/wavio.wav_info``).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from speakerverification_tpu_torch.data.wavio import wav_info

__all__ = ["Manifest", "generate_metadata"]


@dataclasses.dataclass
class Manifest:
    paths: list
    labels: list          # contiguous int labels
    speakers: list        # index -> original speaker id

    @property
    def num_classes(self) -> int:
        return len(self.speakers)

    def __len__(self) -> int:
        return len(self.paths)

    @classmethod
    def read(cls, csv_path: str | Path) -> "Manifest":
        rows = []
        with open(csv_path, newline="") as rf:
            reader = csv.reader(rf)
            next(reader, None)                      # header
            for row in reader:
                if len(row) >= 2:
                    rows.append((row[0], row[1]))
        speakers = sorted({r[0] for r in rows})
        label_of = {s: i for i, s in enumerate(speakers)}
        return cls(paths=[r[1] for r in rows],
                   labels=[label_of[r[0]] for r in rows],
                   speakers=speakers)

    @staticmethod
    def write(csv_path: str | Path, rows: Iterable[Sequence]) -> None:
        csv_path = Path(csv_path)
        csv_path.parent.mkdir(parents=True, exist_ok=True)
        with open(csv_path, "w", newline="") as wf:
            writer = csv.writer(wf)
            writer.writerow(["ID", "path", "duration", "audio_format"])
            writer.writerows(rows)


def generate_metadata(data_folder: str | Path,
                      save_dir: str | Path,
                      split_ratio: float = -1,
                      min_utts_per_spk: int = 0,
                      max_utts_per_spk: int = -1,
                      num_val_utts: int = 3,
                      seed: int = 0,
                      extensions: Sequence[str] = ("wav",)) -> dict:
    """Scan ``data_folder/<speaker>/**.wav`` into ``train.csv`` and
    ``dev.csv`` under ``save_dir``: per-speaker min/max utterance
    filters; the validation split is ``num_val_utts`` per speaker when
    ``split_ratio <= 0``, else that ratio of each speaker's files."""
    data_folder = Path(data_folder)
    save_dir = Path(save_dir)
    rng = np.random.default_rng(seed)

    by_speaker: dict[str, list[Path]] = {}
    for spk_dir in sorted(p for p in data_folder.iterdir() if p.is_dir()):
        files = sorted(f for ext in extensions
                       for f in spk_dir.rglob(f"*.{ext}"))
        if len(files) < max(min_utts_per_spk, 1):
            continue
        if max_utts_per_spk > 0:
            files = files[:max_utts_per_spk]
        by_speaker[spk_dir.name] = files

    def row(spk: str, f: Path):
        sr, n, _ = wav_info(f)
        return [spk, str(f), round(n / sr, 3), f.suffix.lstrip(".")]

    train_rows, dev_rows = [], []
    for spk, files in by_speaker.items():
        files = list(files)
        perm = rng.permutation(len(files))
        if split_ratio and split_ratio > 0:
            n_val = max(1, int(len(files) * split_ratio))
        else:
            n_val = min(num_val_utts, max(len(files) - 1, 0))
        val_idx = set(perm[:n_val].tolist())
        for i, f in enumerate(files):
            (dev_rows if i in val_idx else train_rows).append(row(spk, f))

    Manifest.write(save_dir / "train.csv", train_rows)
    Manifest.write(save_dir / "dev.csv", dev_rows)
    return {"n_speakers": len(by_speaker), "n_train": len(train_rows),
            "n_dev": len(dev_rows)}
