"""Data-preparation command line (port of ``cli/dataprep.py``).

    python -m speakerverification_tpu_torch.cli.dataprep --generate --config y.yaml
    python -m speakerverification_tpu_torch.cli.dataprep --pack OUT_DIR [--shard_mb 1024] --config y.yaml

The actions run in this order, each when its flag is given: ``--generate``
(``train.csv``/``dev.csv`` beside ``train_annotation`` from
``data_folder``), ``--download FILE`` (``url md5`` lines), ``--extract
ARCHIVE``, ``--convert`` (m4a/mp3/flac/ogg under ``data_folder`` to WAV
with ffmpeg), ``--split_musan`` (also before ``--augment``),
``--augment`` (env-corrupted copies of the train manifest under
``augmented/`` beside ``data_folder``), ``--restore``, ``--vad``,
``--stats``, ``--filter`` (quarantine beside ``data_folder``) and
``--pack`` (the train manifest into shards for
``dataloader_options.shards``). Host code only: no device is used.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from speakerverification_tpu_torch.config import read_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("speakerverification_tpu_torch.cli.dataprep")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--generate", action="store_true")
    p.add_argument("--download", type=str, default=None,
                   help="file of 'url md5' lines")
    p.add_argument("--extract", type=str, default=None, help="archive path")
    p.add_argument("--convert", action="store_true",
                   help="convert non-wav audio under data_folder")
    p.add_argument("--split_musan", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="write offline-augmented copies")
    p.add_argument("--restore", action="store_true")
    p.add_argument("--vad", action="store_true")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--filter", action="store_true")
    p.add_argument("--pack", type=str, default=None, metavar="OUT_DIR",
                   help="pack the train manifest into raw-PCM shards and an "
                        "index (data/shards.py); train from them with "
                        "dataloader_options: {shards: OUT_DIR}")
    p.add_argument("--shard_mb", type=int, default=1024,
                   help="largest shard file for --pack (MiB)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    h = read_config(args.config)
    data_folder = h.get("data_folder", ".")

    if args.generate:
        from speakerverification_tpu_torch.data.manifest import (
            generate_metadata,
        )
        stats = generate_metadata(
            data_folder, Path(h["train_annotation"]).parent,
            split_ratio=float(h.get("dataloader_options", {})
                              .get("split_ratio", -1)),
            seed=int(h.get("seed", 0)))
        print(json.dumps(stats))

    if args.download:
        from speakerverification_tpu_torch.data.dataprep import download
        lines = Path(args.download).read_text().splitlines()
        for path, status in download(data_folder, lines):
            print(f"{path}: {status}")

    if args.extract:
        from speakerverification_tpu_torch.data.dataprep import full_extract
        full_extract(data_folder, args.extract)
        print(f"extracted {args.extract}")

    if args.convert:
        from speakerverification_tpu_torch.data.dataprep import convert_to_wav
        files = [f for ext in ("m4a", "mp3", "flac", "ogg")
                 for f in Path(data_folder).rglob(f"*.{ext}")]
        print(json.dumps(convert_to_wav(
            files, sample_rate=int(h["audio_spec"]["sample_rate"]))))

    if args.split_musan or args.augment:
        from speakerverification_tpu_torch.data.dataprep import split_musan
        n = split_musan(h.get("noise_folder", data_folder))
        print(f"split_musan: {n} chunks")

    if args.augment:
        from speakerverification_tpu_torch.data.dataprep import (
            offline_augmentation,
        )
        from speakerverification_tpu_torch.data.manifest import Manifest
        m = Manifest.read(h["train_annotation"])
        n = offline_augmentation(m.paths, h["augment_options"],
                                 h["audio_spec"],
                                 Path(data_folder).parent / "augmented")
        print(f"augmented: {n} files")

    if args.restore:
        from speakerverification_tpu_torch.data.dataprep import (
            restore_dataset,
        )
        print(f"removed {restore_dataset(data_folder)} generated files")

    if args.vad:
        from speakerverification_tpu_torch.data.dataprep import vad_on_dataset
        print(f"vad: {vad_on_dataset(data_folder)} files segmented")

    if args.stats:
        from speakerverification_tpu_torch.data.quality import (
            dataset_statistics,
        )
        s = dataset_statistics(data_folder)
        s.pop("files")
        print(json.dumps(s, indent=2))

    if args.filter:
        from speakerverification_tpu_torch.data.quality import (
            filter_low_quality,
        )
        out = filter_low_quality(data_folder,
                                 Path(data_folder).parent / "quarantine")
        print(json.dumps({"n_moved": out["n_moved"], "n_kept": out["n_kept"]}))

    if args.pack:
        from speakerverification_tpu_torch.data.manifest import Manifest
        from speakerverification_tpu_torch.data.shards import pack_shards
        stats = pack_shards(Manifest.read(h["train_annotation"]), args.pack,
                            shard_mb=args.shard_mb,
                            sample_rate=int(h["audio_spec"]["sample_rate"]))
        print(json.dumps(stats))

    return 0


if __name__ == "__main__":
    sys.exit(main())
