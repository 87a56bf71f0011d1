"""Training orchestration (port of ``training/trainer.py``).

Epochs of train steps (``train_step.make_train_step``) over the
speaker-balanced loader, the learning rate from the schedule per epoch
or per iteration, best/top-k/last checkpoints in the JAX package's
layout (``training/checkpoint.py``) with resume, the ``scores.txt``
line per epoch, optional validation EER (``test_interval``), early
stopping, ``settings.txt``, a checkpoint on SIGTERM/SIGINT, and
TensorBoard scalars when ``tensorboardX`` imports.

Augmentation: with ``augment: true`` the loader runs the host chain
(``data/augment.py``). ``device_augment: true`` moves its env_corrupt
into the train step (``ops/device_augment.py``: the loader's engine is
detached, noise and RIR banks of ``device_augment_noise_bank`` /
``device_augment_rir_bank`` clips live on the device and are rebuilt
from the corpus each epoch after the first, from
``numpy.random.default_rng(seed * 7919 + epoch)``; the first build is
unseeded, as in the JAX trainer). ``device_time_augment`` (``true`` for
``'np'``, or ``'np'`` / ``'torch'``) adds ``ops/timeaugment.py``'s chain
after it. The step's generator (which also draws SpecAugment's masks
and dropout's) is seeded from ``seed * 1000 + epoch`` at each epoch's
start; its state is not checkpointed (the JAX trainer keeps no rng
state either).

The model runs on CUDA unless the caller asks for the CPU. ``profile:
true`` with a ``profile_dir`` runs the first epoch under
``torch.profiler`` (the host, and the card when training on one) and
writes it as chrome-trace JSON to ``profile_dir/trace.json``, where the
JAX trainer writes a TensorBoard trace; the trace holds the train step's
spans (``utils/tracing.py``) as ranges, and the log a line of the step's
host time and, on a card, its phases' stream time. The loader reads
packed shards when ``dataloader_options.shards`` names a pack
(``cli.dataprep --pack``).

Several GPUs: with ``distributed`` (or its alias ``data_parallel``) and a
process group configured (``parallel.maybe_initialize_distributed``:
one process per GPU), each process trains on its data rank's shard of
the sampler (``num_replicas``/``rank``; ``batch_size`` is per process,
as the reference's per-GPU DDP batch) with the data-parallel step
(``parallel/dp.py``), or with ``model_parallel: m`` the data × model
step with the class-sharded head (``parallel/tp.py``; the world must be
a multiple of m). One process trains as on one device.
``sharded_checkpoints`` keeps checkpoints as sharded directories
(``training/checkpoint_sharded.py``). Rank 0 alone logs, validates and
writes msgpack checkpoints; every rank takes part in a checkpoint of a
sharded head (its rows are gathered) and writes its part of a sharded
one. A preemption signal stops every rank at the end of the epoch.
"""

from __future__ import annotations

import contextlib
import signal
import time
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from speakerverification_tpu_torch.builder import (
    compute_dtype_from_hparams,
    encoder_from_hparams,
    optimizer_from_hparams,
    scheduler_from_hparams,
)
from speakerverification_tpu_torch.data.loader import train_data_loader
from speakerverification_tpu_torch.data.manifest import Manifest
from speakerverification_tpu_torch.evaluation.evaluator import (
    evaluate_from_list,
)
from speakerverification_tpu_torch.evaluation.metrics import (
    tune_threshold_from_score,
)
from speakerverification_tpu_torch.inference import (
    make_eval_embed_fn,
    resolve_device,
    run_dirs,
)
from speakerverification_tpu_torch.ops.device_augment import (
    build_banks,
    device_env_corrupt,
)
from speakerverification_tpu_torch.ops.timeaugment import time_augment
from speakerverification_tpu_torch.optim import EarlyStopping
from speakerverification_tpu_torch.parallel import (
    make_dp_tp_train_step,
    make_dp_train_step,
    make_mesh,
    maybe_initialize_distributed,
    replicate_state,
    shard_state_tp,
)
from speakerverification_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_params_only,
)
from speakerverification_tpu_torch.training.state import create_train_state
from speakerverification_tpu_torch.training.train_step import (
    eval_dp_devices,
    make_train_step,
)
from speakerverification_tpu_torch.utils import tracing

__all__ = ["Trainer", "device_augmentation", "run_dirs"]


def _bank_sizes(hparams: Mapping) -> tuple[int, int]:
    """Noise crops and RIRs per bank (``device_augment_noise_bank``,
    ``device_augment_rir_bank``)."""
    return (int(hparams.get("device_augment_noise_bank", 256)),
            int(hparams.get("device_augment_rir_bank", 64)))


def device_augmentation(hparams: Mapping, loader, device):
    """``(augment_fn, banks, bank_source)`` of ``device_augment`` and
    ``device_time_augment`` for the train step, or Nones. With
    ``device_augment`` the loader's env_corrupt engine is detached (it
    becomes the banks' source); the first banks are drawn unseeded, as
    the JAX trainer draws them."""
    banks = source = env_fn = None
    if hparams.get("device_augment") and loader.augmentor is not None:
        # the loader serves clean crops; env_corrupt mixes on the device
        source = loader.augmentor
        banks = build_banks(source, *_bank_sizes(hparams), device=device)
        loader.augmentor = None
        env_fn = device_env_corrupt
        print("[INFO] env_corrupt moved on-device "
              f"(banks: {banks.noise.shape[0]} noise crops, "
              f"{banks.rir.shape[0]} RIRs, refreshed per epoch)")
    tmode = hparams.get("device_time_augment")
    if not tmode:
        fn = (lambda w, r, b: env_fn(w, b, r)) if env_fn else None
        return fn, banks, source
    t_mode = tmode if isinstance(tmode, str) else "np"
    t_sr = int(dict(hparams.get("audio_spec") or {}).get("sample_rate",
                                                          16000))
    if banks is None and loader.augmentor is not None:
        # banks feed the chain's background-noise and IR members; a host
        # env_corrupt stays on the host
        source = loader.augmentor
        banks = build_banks(source, *_bank_sizes(hparams), device=device)
    print(f"[INFO] on-device TimeAugment chain enabled (mode={t_mode}"
          + (", no banks: background-noise/IR members skipped"
             if banks is None else "") + ")")

    def augment(w, r, b=None):
        if env_fn is not None:
            w = env_fn(w, b, r)
        return time_augment(w, r, b, mode=t_mode, sample_rate=t_sr)
    return augment, banks, source


def _phase_line(spans: list) -> str:
    """The profiled epoch's mean host time a step and, on a card, each
    phase's stream time a step (its CUDA events), from its spans."""
    steps = [s for s in spans if s.name == "train.step"]
    if not steps:
        return "[INFO] no train step was profiled"
    line = (f"[INFO] {len(steps)} profiled steps: "
            f"{sum(s.ms for s in steps) / len(steps):.2f} ms a step on the "
            f"host")
    for phase in ("forward", "backward", "optimizer"):
        ms = [s.device_ms for s in spans if s.name == f"train.{phase}"]
        if ms and None not in ms:
            line += f", {phase} {sum(ms) / len(steps):.2f} ms of stream"
    return line


class Trainer:
    def __init__(self, hparams: Mapping, device=None):
        self.hparams = dict(hparams)
        if self.hparams.get("data_parallel"):
            self.hparams["distributed"] = True
        self.model_parallel = int(self.hparams.get("model_parallel", 1) or 1)
        if self.model_parallel > 1 and not self.hparams.get("distributed"):
            raise ValueError(f"model_parallel={self.model_parallel} "
                             "requires --distributed")
        self.multiprocess = False
        if self.hparams.get("distributed"):
            if device is not None:
                self.hparams.setdefault("device", str(device))
            self.multiprocess = maybe_initialize_distributed(self.hparams)
        world = dist.get_world_size() if self.multiprocess else 1
        if self.model_parallel > 1 and (world < self.model_parallel
                                        or world % self.model_parallel):
            raise ValueError(
                f"model_parallel={self.model_parallel} requires a world of "
                f"a multiple of {self.model_parallel} processes (have "
                f"{world})")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.is_main = not self.multiprocess or dist.get_rank() == 0
        self.dirs = run_dirs(self.hparams)

        # several processes: a 1-D data mesh, or data x model; the
        # sampler shards by data rank (the ranks of a model group train
        # on the same batch)
        self.mesh = None
        n_data, data_rank = 1, 0
        if self.multiprocess:
            mp_ = self.model_parallel
            self.mesh = (make_mesh(("data", "model"), (world // mp_, mp_))
                         if mp_ > 1 else make_mesh(("data",)))
            n_data = world // mp_
            data_rank = self.mesh.get_local_rank("data")
        self.loader = train_data_loader(self.hparams, n_data, data_rank)
        if self.loader.manifest.num_classes != int(
                self.hparams.get("nClasses", 0)):
            print(f"[WARN] nClasses={self.hparams.get('nClasses')} in config "
                  f"but {self.loader.manifest.num_classes} speakers in "
                  f"manifest; using the manifest count")
            self.hparams["nClasses"] = self.loader.manifest.num_classes

        self.model = encoder_from_hparams(self.hparams, with_loss=True,
                                          num_devices=world).to(self.device)
        self.tx = optimizer_from_hparams(self.hparams)
        self.steps_per_epoch = max(len(self.loader), 1)
        self.schedule, self.lr_unit = scheduler_from_hparams(
            self.hparams, self.steps_per_epoch)
        self._compute_dtype = compute_dtype_from_hparams(self.hparams)
        self.accum_steps = int(self.hparams.get("accumulate_steps", 1))
        if self.accum_steps > 1:
            if int(self.hparams.get("batch_size", 0)) % self.accum_steps:
                if self.mesh is not None:
                    # one data shard per process: a shard's rows are
                    # batch_size
                    raise ValueError(
                        f"accumulate_steps={self.accum_steps} must divide "
                        f"each data shard's rows: batch_size "
                        f"{self.hparams.get('batch_size')} over 1 shards "
                        f"gives {self.hparams.get('batch_size')} "
                        "rows/shard")
                raise ValueError(
                    f"accumulate_steps={self.accum_steps} must divide "
                    f"batch_size {self.hparams.get('batch_size')}")
            print(f"[INFO] gradient accumulation: {self.accum_steps} "
                  "microbatches per optimizer step")
        (self._augment_fn, self._aug_banks,
         self._aug_source) = device_augmentation(self.hparams, self.loader,
                                                 self.device)
        if self.mesh is None:
            self.step_fn = make_train_step(self.model, self.tx,
                                           compute_dtype=self._compute_dtype,
                                           accum_steps=self.accum_steps,
                                           augment_fn=self._augment_fn)
        elif self.model_parallel > 1:
            self.step_fn = None    # built in fit(): it names the state's shards
        else:
            self.step_fn = make_dp_train_step(
                self.model, self.tx, self.mesh,
                compute_dtype=self._compute_dtype, augment_fn=self._augment_fn,
                accum_steps=self.accum_steps)
        if self.mesh is not None and self.is_main:
            print(f"[INFO] data-parallel over {n_data} processes"
                  + (f" x {self.model_parallel} model shards"
                     if self.model_parallel > 1 else ""))
        self.rng = torch.Generator(device=self.device)

        self.ckpt = CheckpointManager(
            self.dirs["model"], top_k=3,
            save_per_epoch=not self.hparams.get("save_model_last", True),
            time_interval_min=float(self.hparams.get("ckpt_interval_minutes",
                                                     -1)),
            backend=("sharded" if self.hparams.get("sharded_checkpoints")
                     else "msgpack"))
        self.early_stopping: Optional[EarlyStopping] = None
        if self.hparams.get("early_stopping"):
            self.early_stopping = EarlyStopping(
                patience=int(self.hparams.get("es_patience", 15)))

        self._writer = None
        if self.is_main:
            with open(self.dirs["result"] / "settings.txt", "a") as f:
                f.write(f"\n[{time.strftime('%Y-%m-%d %H:%M:%S')}]\n")
                for k in sorted(self.hparams):
                    f.write(f"{k}: {self.hparams[k]!r}\n")
            try:
                from tensorboardX import SummaryWriter
                runs = self.dirs["result"] / "runs"
                runs.mkdir(exist_ok=True)
                self._writer = SummaryWriter(log_dir=str(runs))
            except ImportError:
                pass

        # profile: the first epoch's torch.profiler trace, written as
        # chrome-trace JSON to profile_dir/trace.json (by rank 0)
        self._profile_dir = (Path(str(self.hparams["profile_dir"]))
                             if self.hparams.get("profile") and self.is_main
                             and self.hparams.get("profile_dir") else None)
        self.state = None
        self._preempt = False
        self.init_epoch = 1
        self.min_loss = float("inf")
        self.min_eer = float("inf")

    # ------------------------------------------------------------------
    def _init_state(self) -> None:
        self.state = create_train_state(self.model, self.tx,
                                        int(self.hparams.get("seed", 0)))
        # resume: configured pretrained > this run's latest > scratch
        resume = None
        pre = self.hparams.get("pretrained", {}) or {}
        if pre.get("use") and pre.get("path") and Path(
                str(pre["path"])).exists():
            resume = Path(str(pre["path"]))
        elif self.ckpt.latest() is not None:
            resume = self.ckpt.latest()
        if resume is None:
            self._place_state()
            return
        try:
            self.state = load_checkpoint(resume, self.state)
        except ValueError:
            # written under another optimizer: restore the weights only
            self.state = load_params_only(resume, self.state)
            print("[WARN] optimizer state in checkpoint incompatible — "
                  "restored weights only")
        meta = self.ckpt.resume_meta()
        self.init_epoch = int(meta.get("epoch", 0)) + 1
        self.min_loss = min(float(meta.get("loss", float("inf"))),
                            self.ckpt._best_loss)
        print(f"[INFO] resumed from {resume} at epoch {self.init_epoch}")
        self._place_state()

    def _place_state(self) -> None:
        """Several processes: the state made equal on every rank (rank
        0's), or the head's rows cut for this rank's model shard and the
        data x model step built on it."""
        if self.mesh is None:
            return
        if self.model_parallel > 1:
            self.state = shard_state_tp(self.state, self.mesh)
            self.step_fn = make_dp_tp_train_step(
                self.model, self.tx, self.mesh, self.state,
                compute_dtype=self._compute_dtype,
                augment_fn=self._augment_fn, accum_steps=self.accum_steps)
        else:
            replicate_state(self.state, self.mesh)

    def _lr(self, epoch: int, it: int, global_it: int) -> float:
        if self.lr_unit == "iteration":
            return float(self.schedule(global_it))
        if self.lr_unit == "epoch":
            return float(self.schedule(epoch - 1))
        return float(self.schedule.lr)          # plateau: the current lr

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> tuple[float, float]:
        self.loader.set_epoch(epoch)
        if self._aug_source is not None and epoch != self.init_epoch:
            # fresh noise and RIR clips from the corpus, the same shapes
            self._aug_banks = build_banks(
                self._aug_source, *_bank_sizes(self.hparams),
                rng=np.random.default_rng(
                    int(self.hparams.get("seed", 0)) * 7919 + epoch),
                device=self.device)
        self.rng.manual_seed(int(self.hparams.get("seed", 0)) * 1000 + epoch)
        aug = (self._aug_banks,) if self._aug_banks is not None else ()
        losses, accs = [], []
        t0 = time.time()
        n_utts = 0
        profiling = self._profile_dir is not None and epoch == self.init_epoch
        with self._profiler() if profiling else contextlib.nullcontext() \
                as prof:
            for it, batch in enumerate(self.loader):
                if self._preempt and not self.multiprocess:
                    # several processes run the epoch out: the signal may
                    # reach them at different steps (fit() agrees at the
                    # epoch's end)
                    break
                lr = self._lr(epoch, it,
                              (epoch - 1) * self.steps_per_epoch + it)
                wave = torch.from_numpy(batch["wave"]).to(self.device)
                label = torch.from_numpy(batch["label"]).to(self.device)
                self.state, metrics = self.step_fn(self.state, wave, label,
                                                   lr, self.rng, *aug)
                losses.append(metrics["loss"])
                accs.append(metrics["prec1"])
                n_utts += batch["wave"].shape[0] * batch["wave"].shape[1]
            # one device sync per epoch
            loss = (float(torch.stack(losses).mean()) if losses
                    else float("nan"))
            acc = float(torch.stack(accs).mean()) if accs else float("nan")
        dt = time.time() - t0
        if profiling:
            self._profile_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(self._profile_dir / "trace.json"))
            print(f"[INFO] profiler trace written to {self._profile_dir}")
            print(_phase_line(tracing.spans()))
            tracing.clear()     # the trace holds the spans' ranges
        if self.is_main:
            print(f"[E{epoch:03d}] loss {loss:.4f} acc {acc:5.2f}% lr "
                  f"{self._lr(epoch, 0, (epoch - 1) * self.steps_per_epoch):.2e}"
                  f" ({n_utts / max(dt, 1e-9):.1f} utt/s, {dt:.3f} s)")
        return loss, acc

    def _profiler(self):
        """``torch.profiler`` over the host, and the card when training
        on one."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _validation_trials(self) -> Path:
        """A trial list from the dev manifest: each dev utterance in one
        same-speaker and one different-speaker trial."""
        trial_path = self.dirs["result"] / "validation_trials.txt"
        m = Manifest.read(self.hparams["valid_annotation"])
        by_spk: dict[int, list[str]] = {}
        for path, lab in zip(m.paths, m.labels):
            by_spk.setdefault(lab, []).append(path)
        rng = np.random.default_rng(int(self.hparams.get("seed", 0)))
        speakers = sorted(by_spk)
        lines = []
        for s in speakers:
            files = by_spk[s]
            for i, f in enumerate(files):
                if len(files) > 1:
                    lines.append(f"1 {f} {files[(i + 1) % len(files)]}")
                other = speakers[(speakers.index(s) + 1
                                  + int(rng.integers(max(len(speakers) - 1,
                                                         1)))
                                  ) % len(speakers)]
                if other != s and by_spk[other]:
                    neg = by_spk[other][int(rng.integers(len(by_spk[other])))]
                    lines.append(f"0 {f} {neg}")
        trial_path.write_text("\n".join(lines) + "\n")
        return trial_path

    def validate(self) -> float:
        """EER (%) of the model's embeddings on ``valid_annotation`` (a
        trial list, or a dev manifest made into one), scored as
        ``scoring_mode`` says (cosine where a cohort bank is missing)."""
        normalize = bool(getattr(self.model.loss, "test_normalize", True))
        # one process with several GPUs splits the extraction's rows over
        # them (the inference engine's policy); under a mesh the model
        # stays on its own device
        devices = (eval_dp_devices(self.hparams)
                   if self.mesh is None and self.device.type == "cuda"
                   else None)
        embed = make_eval_embed_fn(self.model, normalize=normalize,
                                   compute_dtype=self._compute_dtype,
                                   devices=devices)
        va = str(self.hparams["valid_annotation"])
        listfile = self._validation_trials() if va.endswith(".csv") else va
        mode = str(self.hparams.get("scoring_mode", "cosine"))
        cohorts = None
        if mode in ("norm", "zt_norm"):
            cp = self.hparams.get("cohorts_path")
            if cp and Path(str(cp)).exists():
                cohorts = np.load(str(cp))
            else:
                print(f"[WARN] scoring_mode={mode} but no cohort bank at "
                      f"{cp!r}; validating with cosine")
                mode = "cosine"
        sc, lab, _ = evaluate_from_list(
            embed, listfile, self.hparams["audio_spec"],
            num_eval=int(self.hparams.get("num_eval", 10)),
            scoring_mode=mode, cohorts=cohorts, normalize=False)
        return tune_threshold_from_score(sc, lab, [1, 0.1])["roc"][1]

    # ------------------------------------------------------------------
    def fit(self) -> dict:
        """Train ``number_of_epochs`` epochs. SIGTERM or SIGINT checkpoints
        the unfinished epoch and stops; a second one aborts."""
        n_epochs = int(self.hparams.get("number_of_epochs", 1))
        score_path = self.dirs["result"] / "scores.txt"
        test_interval = int(self.hparams.get("test_interval", -1) or -1)
        self._preempt = False
        old_handlers = {}

        def on_term(signum, frame):
            if self._preempt:
                for s, h in old_handlers.items():
                    signal.signal(s, h)
                raise KeyboardInterrupt
            self._preempt = True
            print(f"[WARN] caught signal {signum} — will checkpoint and "
                  "stop after the current step (send again to abort "
                  "immediately)", flush=True)

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                old_handlers[s] = signal.signal(s, on_term)
        except ValueError:
            pass        # not the main thread
        try:
            return self._fit(n_epochs, score_path, test_interval)
        finally:
            for s, h in old_handlers.items():
                signal.signal(s, h)

    def _fit(self, n_epochs: int, score_path: Path,
             test_interval: int) -> dict:
        self._init_state()
        for epoch in range(self.init_epoch, n_epochs + 1):
            loss, acc = self.train_epoch(epoch)
            if self.multiprocess:
                # stop together when any rank caught the signal
                flag = torch.tensor([int(self._preempt)], device=self.device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                self._preempt = bool(flag.item())
            if self._preempt:
                # a partial epoch: resume runs it again; best/top-k and
                # scores stay
                self.ckpt.save_interrupt(
                    self.state, epoch,
                    lr=self._lr(epoch, 0, (epoch - 1) * self.steps_per_epoch),
                    best_loss=self.min_loss)
                if self.is_main:
                    print(f"[INFO] preemption checkpoint written (epoch "
                          f"{epoch} unfinished) — exiting")
                break
            lr_now = self._lr(epoch, 0, epoch * self.steps_per_epoch)
            if self.lr_unit == "plateau":
                self.schedule(loss)
            improved = loss < self.min_loss
            if improved:
                self.min_loss = loss

            line = (f"epoch {epoch}, LR {lr_now:.8f}, TEER/TAcc {acc:2.2f}, "
                    f"TLOSS {loss:f}")
            if test_interval > 0 and epoch % test_interval == 0 and \
                    self.hparams.get("valid_annotation") and self.is_main:
                veer = self.validate()
                self.min_eer = min(self.min_eer, veer)
                line += f", VEER {veer:2.4f}, MINEER {self.min_eer:2.4f}"
            if self.is_main:
                with open(score_path, "a") as f:
                    f.write(line + "\n")
            # every rank: a sharded head's rows are gathered, a sharded
            # checkpoint written by all
            self.ckpt.save_epoch(self.state, epoch, loss, lr_now)
            if self._writer is not None:
                self._writer.add_scalar("Loss/train", loss, epoch)
                self._writer.add_scalar("Accuracy/train", acc, epoch)
                self._writer.add_scalar("Params/learning_rate", lr_now, epoch)

            if self.early_stopping is not None:
                if improved:
                    self.early_stopping.counter = 0
                if self.early_stopping(loss):
                    if self.is_main:
                        print("[INFO] early stopping")
                    break
        if self._writer is not None:
            self._writer.close()
        return {"min_loss": self.min_loss, "min_eer": self.min_eer,
                "state": self.state}
