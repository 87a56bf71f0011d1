"""Dataset preparation (port of ``data/dataprep.py``): download with
checksums, part concatenation, archive extraction, conversion to WAV,
MUSAN splitting, offline augmentation, VAD over a dataset and its
restoration.

* ``download`` fetches ``url md5`` lines with ``wget`` and skips a file
  already present with the right checksum (``cached``); without network
  the fetch fails and is reported per line.
* ``convert_to_wav`` runs ffmpeg on a thread pool (each failure counted).
* ``split_musan``: 5 s chunks every 3 s under ``musan_split/``.
* ``offline_augmentation`` writes env-corrupted copies, every draw from
  one ``numpy.random.default_rng(seed)`` in file order.
* ``restore_dataset`` removes the ``*_vad.wav`` / ``*_aug<k>.wav`` files;
  ``vad_on_dataset`` writes the ``*_vad.wav`` ones.
Manifests come from ``data/manifest.generate_metadata``.
"""

from __future__ import annotations

import hashlib
import re
import subprocess
import tarfile
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Mapping

import numpy as np

from speakerverification_tpu_torch.data.audio import AudioSpec, load_wav
from speakerverification_tpu_torch.data.augment import AugmentWav
from speakerverification_tpu_torch.data.vad import VAD
from speakerverification_tpu_torch.data.wavio import read_wav, write_wav

__all__ = ["md5", "download", "concatenate", "full_extract", "split_musan",
           "convert_to_wav", "offline_augmentation", "restore_dataset",
           "vad_on_dataset"]


def md5(fname: str | Path) -> str:
    """The file's MD5, read in 4 MiB pieces."""
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096 * 1024), b""):
            h.update(chunk)
    return h.hexdigest()


def download(save_path: str | Path, lines: Iterable[str]) -> list:
    """Fetch each ``url md5`` line into ``save_path`` with ``wget`` and
    check it; returns ``(path, status)`` per line: ``cached``, ``ok``,
    ``checksum mismatch`` or ``download failed: ...``."""
    results = []
    for line in lines:
        url, target_md5 = line.split()[:2]
        out = Path(save_path) / Path(url).name
        if out.exists() and md5(out) == target_md5:
            results.append((out, "cached"))
            continue
        cmd = ["wget", url, "-O", str(out)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            results.append((out, f"download failed: {e}"))
            continue
        status = "ok" if md5(out) == target_md5 else "checksum mismatch"
        results.append((out, status))
    return results


def concatenate(save_path: str | Path, catlist: str | Path) -> list:
    """For each ``pattern md5`` line, the parts matching ``pattern``
    concatenated in name order into the name without ``_part*``, then
    checked."""
    out = []
    with open(catlist) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            pattern, target_md5 = parts[0], parts[1]
            target = Path(save_path) / pattern.replace("_part*", "")
            with open(target, "wb") as w:
                for piece in sorted(Path(save_path).glob(pattern)):
                    w.write(piece.read_bytes())
            out.append((target, "ok" if md5(target) == target_md5
                        else "checksum mismatch"))
    return out


def full_extract(save_path: str | Path, fname: str | Path) -> None:
    """Extract a zip or tar archive into ``save_path``."""
    fname = Path(fname)
    if fname.suffix == ".zip":
        with zipfile.ZipFile(fname) as zf:
            zf.extractall(save_path)
    else:
        with tarfile.open(fname) as tf:
            tf.extractall(save_path)


def split_musan(noise_folder: str | Path) -> int:
    """Cut ``<noise_folder>/musan/*/*/*.wav`` into 5 s pieces every
    3 s, written under ``musan_split/`` in the same
    layout; returns the number of pieces."""
    noise_folder = Path(noise_folder)
    files = sorted((noise_folder / "musan").glob("*/*/*.wav"))
    n_chunks = 0
    for file in files:
        audio, fs = read_wav(file)
        audlen = int(fs * 5.0)
        audstr = int(fs * 3.0)
        writedir = Path(str(file.with_suffix("")).replace(
            "/musan/", "/musan_split/"))
        writedir.mkdir(parents=True, exist_ok=True)
        for st in range(0, len(audio) - audlen, audstr):
            write_wav(writedir / f"{st // fs:05d}.wav",
                      audio[st:st + audlen], fs)
            n_chunks += 1
    return n_chunks


def _ffmpeg_convert(src: str, dst: str, sample_rate: int) -> bool:
    cmd = ["ffmpeg", "-y", "-i", src, "-ac", "1",
           "-ar", str(sample_rate), "-f", "wav", dst]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def convert_to_wav(files: Iterable[str | Path],
                   sample_rate: int = 16000) -> dict:
    """Convert each file to a mono ``.wav`` beside it with ffmpeg, on
    16 threads; returns ``{"converted", "failed"}``."""
    with ThreadPoolExecutor(max_workers=16) as pool:
        done = list(pool.map(
            lambda f: _ffmpeg_convert(str(f), str(Path(f).with_suffix(".wav")),
                                      sample_rate), files))
    ok = sum(done)
    failed = len(done) - ok
    return {"converted": ok, "failed": failed}


def offline_augmentation(manifest_paths: Iterable[str],
                         augment_options: Mapping, audio_spec: Mapping,
                         out_dir: str | Path) -> int:
    """Write one env-corrupted train crop of each file as
    ``<out_dir>/<speaker>/<stem>_aug0.wav``: the n-th file's crop from
    ``default_rng(n)``, the corruptions all from one ``default_rng(0)``
    in file order. Returns the files written."""
    spec = AudioSpec(audio_spec)
    eng = AugmentWav(augment_options, audio_spec)
    rng = np.random.default_rng(0)
    out_dir = Path(out_dir)
    n = 0
    for path in manifest_paths:
        audio = load_wav(str(path), spec, evalmode=False,
                         rng=np.random.default_rng(n))
        aug = eng.env_corrupt(audio, rng)
        dst = out_dir / Path(path).parent.name / (Path(path).stem + "_aug0.wav")
        write_wav(dst, aug[0], spec.sample_rate)
        n += 1
    return n


def restore_dataset(raw_dataset: str | Path) -> int:
    """Remove the generated files (a stem ending in ``_vad`` or ``_aug``
    and digits) under ``raw_dataset``; a name that only contains them
    elsewhere stays. Returns the number removed."""
    pat = re.compile(r"(_vad|_aug)\d*$")
    removed = 0
    for f in Path(raw_dataset).rglob("*.wav"):
        if pat.search(f.stem):
            f.unlink()
            removed += 1
    return removed


def vad_on_dataset(raw_dataset: str | Path) -> int:
    """Write a ``*_vad.wav`` beside every WAV that has voiced audio, on
    8 threads with one ``VAD`` each (webrtcvad's state is per
    instance); returns the number written."""
    tls = threading.local()

    def run(path):
        if not hasattr(tls, "vad"):
            tls.vad = VAD(mode=3)
        return tls.vad.apply_to_file(path)

    files = [f for f in Path(raw_dataset).rglob("*.wav")
             if not f.stem.endswith("_vad")]
    done = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for result in pool.map(run, files):
            if result is not None:
                done += 1
    return done
