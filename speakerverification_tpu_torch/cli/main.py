"""Command-line entry point of the port (the ported part of ``cli/main.py``).

    python -m speakerverification_tpu_torch.cli.main --do_train --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_infer --eval --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_infer --prepare --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_infer --test --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_infer --predict a.wav b.wav --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_serve --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_export --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --list_components
    python -m speakerverification_tpu_torch.cli.main --sys_info

Every verb runs on CUDA unless ``--device cpu`` is given. Flags that are
not mode flags override the YAML key of the same name (so ``--prepare``
runs the preparation that the YAML key ``prepare`` names, ``cohorts``
by default). ``--do_infer`` runs its verbs in the JAX order (prepare,
eval, test, predict); with none of them it exits 2. The resolved config
is frozen into the run's ``config/config_frozen.yaml``. ``--do_train``
trains (the manifests are generated from ``data_folder`` when
``train_annotation`` is missing; ``--augment`` turns on the yaml's
``augment_options``). ``--do_export`` writes the ``torch.export``
program, the JAX-layout weights and the config to the run's
``model/export/`` (``export.py``; ``quant: int8`` is refused).
``--list_components`` prints the four registries and ``--sys_info`` the
host, torch, CUDA and the devices; neither needs ``--config``.

Several GPUs, one process each (``parallel/multihost.py``):
``--distributed`` (alias ``--data_parallel``) trains data-parallel and
evaluates with the file list split over the processes;
``--model_parallel m`` adds the class-sharded head over m processes.
The processes come from the environment (``SVTPU_COORDINATOR`` /
``SVTPU_NUM_PROCESSES`` / ``SVTPU_PROCESS_ID``, or torchrun's), or, when
none is given and more than one GPU is visible, ``--distributed`` starts
one process per GPU itself on a free local port (``--port`` picks it), as
the reference spawns its DDP workers; the kernels are built once, before.
With one GPU it runs in this process. ``--distributed_backend`` is the
process group's backend (``nccl`` by default on CUDA, ``gloo`` on the
CPU; ``mpi`` and ``ici`` exit 2).

    torchrun --nproc_per_node 4 -m speakerverification_tpu_torch.cli.main \
        --do_train --distributed --config y.yaml
    python -m speakerverification_tpu_torch.cli.main --do_train \
        --distributed --model_parallel 2 --config y.yaml
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from speakerverification_tpu_torch.config import dump_config, read_config

# mode flags select what runs; they never land in the hparams (the YAML
# key ``prepare`` selects cohorts or embed, the ``--prepare`` flag runs it)
_MODE_FLAGS = {"config", "do_train", "do_infer", "do_export", "do_serve",
               "serve_host", "serve_port", "eval", "test", "prepare",
               "predict", "device", "sys_info", "list_components"}



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("speakerverification_tpu_torch")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_infer", action="store_true")
    p.add_argument("--do_export", action="store_true")
    p.add_argument("--do_serve", action="store_true",
                   help="run the dynamic-batching embedding/scoring HTTP "
                        "server")
    p.add_argument("--serve_host", type=str, default=None)
    p.add_argument("--serve_port", type=int, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--prepare", action="store_true")
    p.add_argument("--predict", nargs="*", default=None,
                   help="audio files for identification")
    p.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"],
                   help="where the model runs (default: cuda)")
    p.add_argument("--eval_transport", type=str, default=None,
                   choices=["float32", "int16"],
                   help="host->device wire format of inference batches")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8 embedding extraction (static scales "
                        "calibrated on the first batch)")
    p.add_argument("--average_ckpts", action="store_true", default=None,
                   dest="average_checkpoints",
                   help="average the retained best_state_top{1..k} "
                        "checkpoints before inference (model soup)")
    p.add_argument("--use_ema", action="store_true", default=None,
                   help="serve the EMA weights kept by optimizer.ema_decay")
    p.add_argument("--initial_model_infer", type=str, default=None,
                   help="a msgpack checkpoint of the JAX package or a "
                        "torch.save'd state_dict of the port (.pt)")
    p.add_argument("--test_threshold", type=float, default=None)
    p.add_argument("--scoring_mode", type=str, default=None)
    p.add_argument("--mixedprec", action="store_true", default=None,
                   help="bf16 compute")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--number_of_epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--accumulate_steps", type=int, default=None,
                   help="gradient accumulation: each batch runs as this "
                        "many microbatches, one optimizer update on the "
                        "mean gradient")
    p.add_argument("--test_interval", type=int, default=None)
    p.add_argument("--early_stopping", action="store_true", default=None)
    p.add_argument("--augment", action="store_true", default=None,
                   help="train with the yaml's augment_options")
    p.add_argument("--sys_info", action="store_true",
                   help="print the host, torch, CUDA and the devices")
    p.add_argument("--list_components", action="store_true",
                   help="print every registered model/loss/optimizer/"
                        "scheduler name and exit")
    p.add_argument("--distributed", action="store_true", default=None,
                   help="several GPUs, one process each (data-parallel "
                        "training, split evaluation)")
    p.add_argument("--data_parallel", action="store_true", default=None,
                   help="alias of --distributed")
    p.add_argument("--model_parallel", type=int, default=None,
                   help="shard the classifier head's classes over this "
                        "many processes (needs --distributed)")
    p.add_argument("--distributed_backend", type=str, default=None,
                   choices=["nccl", "gloo", "mpi", "ici"],
                   help="process group backend (default: nccl on CUDA, "
                        "gloo on the CPU)")
    p.add_argument("--port", type=str, default=None,
                   help="rendezvous port on localhost")
    return p


def load_hparams(args: argparse.Namespace) -> dict:
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in _MODE_FLAGS}
    if overrides.pop("data_parallel", None):
        overrides["distributed"] = True
    return read_config(args.config, overrides=overrides)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(argv, n: int, port=None) -> int:
    """Run this command line in ``n`` processes, one per GPU, wired by
    the ``SVTPU_*`` variables on a localhost port; the first rank to fail
    stops the others. Returns the worst exit code."""
    from speakerverification_tpu_torch.ops import _build
    # built once here: the ranks find the libraries and build nothing
    _build.build("mel_frontend", "res2net_cascade", "quant_matmul")
    port = port or _free_port()
    procs = []
    for r in range(n):
        env = {**os.environ, "SVTPU_NUM_PROCESSES": str(n),
               "SVTPU_PROCESS_ID": str(r), "LOCAL_RANK": str(r),
               "SVTPU_COORDINATOR": f"localhost:{port}"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "speakerverification_tpu_torch.cli.main",
             *argv], env=env))
    print(f"[INFO] started {n} processes (rendezvous localhost:{port})")
    rcs = [None] * n
    while any(rc is None for rc in rcs):
        for i, p in enumerate(procs):
            rcs[i] = p.poll()
        if any(rc not in (None, 0) for rc in rcs):
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            rcs = [p.wait() for p in procs]
            break
        time.sleep(0.2)
    return max(abs(rc) for rc in rcs)


def ensure_metadata(hparams: dict) -> None:
    """Write the train/dev manifests from ``data_folder`` when
    ``train_annotation`` is missing (and ``skip_prep`` is off)."""
    ann = hparams.get("train_annotation")
    if not ann or Path(ann).exists() or hparams.get("skip_prep"):
        return
    from speakerverification_tpu_torch.data.manifest import generate_metadata
    data_folder = hparams.get("data_folder")
    if not data_folder or not Path(data_folder).exists():
        raise FileNotFoundError(
            f"train_annotation {ann} missing and data_folder "
            f"{data_folder!r} not found — cannot generate metadata")
    stats = generate_metadata(
        data_folder, Path(ann).parent,
        split_ratio=float(hparams.get("dataloader_options", {})
                          .get("split_ratio", -1)),
        seed=int(hparams.get("seed", 0)))
    print(f"[INFO] generated metadata: {stats}")


def list_components() -> list[str]:
    """One line per registry, as the JAX CLI prints them."""
    from speakerverification_tpu_torch.builder import fill_registry
    from speakerverification_tpu_torch.losses import LOSSES
    from speakerverification_tpu_torch.optim import OPTIMIZERS
    from speakerverification_tpu_torch.registry import MODELS, SCHEDULERS
    fill_registry()
    lines = []
    for title, reg in (("models", MODELS), ("losses", LOSSES),
                       ("optimizers", OPTIMIZERS),
                       ("schedulers", SCHEDULERS)):
        names = sorted(reg.names())
        lines.append(f"{title} ({len(names)}): {', '.join(names)}")
    return lines


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_components:
        print("\n".join(list_components()))
        return 0
    if args.sys_info:
        from speakerverification_tpu_torch.utils.sysinfo import (
            format_sys_information,
        )
        print(format_sys_information())
        if not args.config:
            return 0
    if args.distributed_backend in ("mpi", "ici"):
        from speakerverification_tpu_torch.parallel.multihost import (
            distributed_backend,
        )
        try:
            distributed_backend({"distributed_backend":
                                 args.distributed_backend})
        except ValueError as exc:
            print(str(exc), file=sys.stderr)
            return 2
    if not args.config:
        print("--config is required", file=sys.stderr)
        return 2
    hparams = load_hparams(args)
    if hparams.get("distributed") and (args.do_train or args.do_infer):
        from speakerverification_tpu_torch.parallel.multihost import (
            maybe_initialize_distributed,
            rendezvous,
        )
        import torch
        n_gpu = torch.cuda.device_count() if args.device != "cpu" else 0
        if rendezvous(hparams) is None and n_gpu > 1:
            return spawn_ranks(list(argv if argv is not None
                                    else sys.argv[1:]), n_gpu, args.port)
        maybe_initialize_distributed({**hparams, "device": args.device})
    from speakerverification_tpu_torch.inference import run_dirs
    from speakerverification_tpu_torch.parallel.multihost import is_main
    if is_main():
        dump_config(hparams,
                    run_dirs(hparams)["config"] / "config_frozen.yaml")

    if args.do_train:
        ensure_metadata(hparams)
        from speakerverification_tpu_torch.training.trainer import Trainer
        result = Trainer(hparams, device=args.device).fit()
        print(f"[DONE] min_loss {result['min_loss']:.4f}")
        return 0

    if args.do_infer:
        # --predict with no files parses to []
        if args.predict is not None and not args.predict:
            print("--predict needs at least one audio file", file=sys.stderr)
            return 2
        if not (args.eval or args.test or args.prepare or args.predict):
            print("--do_infer needs --eval, --test, --prepare or --predict",
                  file=sys.stderr)
            return 2
        from speakerverification_tpu_torch.inference import inference
        out = inference(hparams, eval_=args.eval, test=args.test,
                        prepare=args.prepare, predict=args.predict,
                        device=args.device)
        for name, score in out.get("predict", []):
            print(f"[RESULT] predict: {name} {score:.6f}")
        return 0

    if args.do_export:
        from speakerverification_tpu_torch.export import export_model
        export_model(hparams, device=args.device)
        return 0

    if args.do_serve:
        from speakerverification_tpu_torch.serving import serve
        serving = hparams.get("serving") or {}
        serve(hparams, host=args.serve_host or serving.get("host", "0.0.0.0"),
              port=int(args.serve_port or serving.get("port", 8008)),
              device=args.device)
        return 0

    print("nothing to do: pass --do_train, --do_infer, --do_export or "
          "--do_serve", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
