"""Embedding extraction and the inference verbs (port of
``make_eval_embed_fn`` from ``training/train_step.py`` and of
``InferenceEngine``/``inference`` from ``inference.py``).

The engine runs on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit device it raises. Its weights, as the
JAX engine chooses them (:func:`_select_weights`): an explicit file or
``initial_model_infer``, else the run's ``best_state``, ``last_state``
or newest ``model_state_*`` msgpack checkpoint; ``average_checkpoints``
averages the retained ``best_state_top*`` ("model soup") and
``use_ema`` serves the EMA weights. Checkpoints are the JAX package's
msgpack files (``checkpoint.py``); a ``.pt`` file is a ``torch.save``d
port ``state_dict``. Without weights the model gets random weights from
the config's seed. ``quant: int8`` extracts through the int8 GEMMs of
``quant.py``, calibrated on the first batch. The verbs: ``evaluate``
(``--eval``), ``test`` (``--test``), ``prepare`` (``--prepare``) and
``predict`` (``--predict``).
"""

from __future__ import annotations

import copy
import csv
import functools
import time
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from speakerverification_tpu_torch.builder import (
    compute_dtype_from_hparams,
    encoder_from_hparams,
    eval_normalize_from_hparams,
)
from speakerverification_tpu_torch.checkpoint import (
    average_checkpoints,
    load_ema_params,
    load_params_only,
)
from speakerverification_tpu_torch.evaluation.evaluator import (
    evaluate_from_list,
    predict_identity,
    prepare_cohorts,
    prepare_embeddings,
    test_from_list,
)
from speakerverification_tpu_torch.evaluation.metrics import (
    compute_error_rates,
    compute_min_dcf,
    tune_threshold_from_score,
)
from speakerverification_tpu_torch.evaluation.reports import (
    classification_report,
    dump_fa_fr_pairs,
    fbeta_score,
)
from speakerverification_tpu_torch.ops import quant_matmul
from speakerverification_tpu_torch.parallel.multihost import (
    is_main,
    is_multiprocess,
)
from speakerverification_tpu_torch.quant import (
    calibrate_act_scales,
    check_calibratable,
    make_int8_embed_fn,
)
from speakerverification_tpu_torch.training.train_step import (
    eval_dp_devices,
)
from speakerverification_tpu_torch.utils import tracing
from speakerverification_tpu_torch.weights import (
    cast_copy,
    init_weights_,
    params_from_jax,
    params_to_jax,
)

__all__ = ["EvalEmbed", "InferenceEngine", "inference", "make_eval_embed_fn",
           "resolve_device", "run_dirs"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; asking for CUDA without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def run_dirs(hparams: Mapping, create: bool = True) -> dict:
    """``save/<model>/<loss>/{model,result,config}``, created unless
    ``create`` is false (own copy of ``training/trainer.py``'s layout)."""
    base = Path(hparams.get("save_folder", "save"))
    model = hparams.get("model", {}).get("name", "model")
    if isinstance(model, (list, tuple)):     # mixed multi-encoder config
        model = "+".join(str(m) for m in model)
    crit = hparams.get("criterion", {}).get("name", "loss")
    root = base / str(model) / str(crit)
    dirs = {"root": root, "model": root / "model", "result": root / "result",
            "config": root / "config"}
    for d in dirs.values() if create else ():
        d.mkdir(parents=True, exist_ok=True)
    return dirs


def _select_weights(hparams: Mapping, model_dir: Path) -> Optional[Path]:
    """``initial_model_infer`` > ``best_state`` > ``last_state`` > the
    newest ``model_state_*``. A name that exists both as a msgpack file
    and as an orbax directory gives the newer of the two; either loads
    (``checkpoint.load_checkpoint``)."""
    cand = hparams.get("initial_model_infer")
    if cand and Path(str(cand)).exists():
        return Path(str(cand))
    for name in ("best_state", "last_state"):
        cands = [p for p in (model_dir / (name + ".msgpack"),
                             model_dir / name) if p.exists()]
        if cands:
            return max(cands, key=lambda p: p.stat().st_mtime)
    epochs = sorted(
        set(model_dir.glob("model_state_*.msgpack"))
        | {p for p in model_dir.glob("model_state_*") if p.is_dir()},
        key=lambda p: p.name.removesuffix(".msgpack"))
    return epochs[-1] if epochs else None


class EvalEmbed(nn.Module):
    """``wave [B, T]`` fp32 -> embeddings ``[B, D]`` fp32, L2-normalized
    when ``normalize``: the eval forward that :func:`make_eval_embed_fn`
    runs and ``export.export_model`` exports."""

    def __init__(self, model: nn.Module, normalize: bool = True):
        super().__init__()
        self.model = model
        self.normalize = normalize

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        emb = self.model(wave).float()
        if self.normalize:
            emb = emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-12)
        return emb


def make_eval_embed_fn(model: nn.Module, normalize: bool = True,
                       compute_dtype: Optional[torch.dtype] = None,
                       devices=None) -> Callable:
    """Build ``embed(wave [B, T]) -> [B, D]`` fp32 on the model's device.

    int16 waves (the serving wire format) are dequantized ×1/32768 on the
    device. With ``compute_dtype`` the parameters (not the BatchNorm
    statistics) of a copy of the model are cast to it; the frontend
    stays fp32 either way. Embeddings are L2-normalized when
    ``normalize`` (the loss head's ``test_normalize``). The function's
    ``module`` attribute is the :class:`EvalEmbed` it runs.

    ``devices`` (two or more; ``training.train_step.eval_dp_devices``):
    the batch's rows are split over them in order, each device running a
    copy of the model (a device named twice runs its copy twice), and
    the embeddings come back in order on the model's device. Eval-mode
    embedding is per-row math, so the result is the one-device result;
    a batch that does not divide is padded by repeating rows (real
    utterances, not silence) and cut back.

    While a profiler runs (``utils/tracing.py``), each device's copy and
    dequantization is an ``engine.h2d`` span and its forward an
    ``engine.forward`` span, both with CUDA events: a pageable copy
    holds the host until the stream's earlier work is done, so the
    copy's own time is the events', not the span's on the host."""
    if compute_dtype is not None:
        model = cast_copy(model, compute_dtype)
    model.eval()
    device = next(model.parameters()).device
    module = EvalEmbed(model, normalize).eval()

    def run(m: nn.Module, dev, wave) -> torch.Tensor:
        with tracing.span("engine.h2d", device=dev):
            wave = torch.as_tensor(wave).to(dev, non_blocking=True)
            if wave.dtype == torch.int16:
                wave = wave.float() * (1.0 / 32768.0)
        with tracing.span("engine.forward", device=dev):
            return m(wave)

    if devices is None or len(devices) < 2:
        @torch.inference_mode()
        def embed(wave) -> torch.Tensor:
            return run(module, device, wave)

        embed.module = module
        return embed

    devices = [torch.device(d) for d in devices]
    replicas = {device: module}
    for d in devices:
        if d not in replicas:
            replicas[d] = copy.deepcopy(module).to(d).eval()
    n = len(devices)

    @torch.inference_mode()
    def embed_dp(wave) -> torch.Tensor:
        wave = torch.as_tensor(wave)
        B = wave.shape[0]
        pad = (-B) % n
        if pad:
            wave = wave[torch.arange(B + pad) % B]
        rows = (B + pad) // n
        outs = [run(replicas[d], d, wave[i * rows:(i + 1) * rows])
                for i, d in enumerate(devices)]
        out = torch.cat([o.to(device) for o in outs])
        return out[:B] if pad else out

    embed_dp.module = module
    embed_dp.devices = devices
    return embed_dp


class InferenceEngine:
    def __init__(self, hparams: Mapping, weights: Optional[str] = None,
                 device=None):
        self.hparams = dict(hparams)
        self.device = resolve_device(device)
        quant = self.hparams.get("quant")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (expected 'int8')")
        self.model = encoder_from_hparams(self.hparams)
        if quant == "int8":
            # a GRU model's calibration fails in JAX too: refuse it now,
            # not at the first batch
            check_calibratable(self.model)
        gen = torch.Generator().manual_seed(int(self.hparams.get("seed", 0)))
        init_weights_(self.model, gen)
        self.weights_path = self._load_weights(weights)
        self.model.to(self.device).eval()

        transport = str(self.hparams.get("eval_transport", "float32"))
        if transport not in ("float32", "int16"):
            raise ValueError(f"eval_transport must be float32|int16, "
                             f"got {transport!r}")
        self._transport = transport
        # the embed fn applies the head's test_normalize; scoring below
        # must not normalize again
        self._normalize = eval_normalize_from_hparams(self.hparams)
        self._compute_dtype = compute_dtype_from_hparams(self.hparams)
        # eval data parallelism over the local GPUs (eval_dp_devices); an
        # int8 engine runs on one device, as the JAX engine does
        devices = None if self.device.type != "cuda" \
            else eval_dp_devices(self.hparams)
        if devices and quant == "int8":
            print("[INFO] --quant int8 runs single-device "
                  "(eval data parallelism applies to the float path)")
            devices = None
        elif devices:
            print(f"[INFO] eval data parallelism over {len(devices)} local "
                  "devices")
        self._float_embed = make_eval_embed_fn(
            self.model, normalize=self._normalize,
            compute_dtype=self._compute_dtype, devices=devices)
        # int8: static activation scales, calibrated on the first batch
        self.act_scales: Optional[dict] = None
        self._embed = None if quant == "int8" else self._float_embed

    @functools.cached_property
    def dirs(self) -> dict:
        """The run's directories, created on first use."""
        return run_dirs(self.hparams)

    def _load_weights(self, weights: Optional[str]) -> Optional[Path]:
        """The JAX engine's loading branch (``inference.py:93-140``) onto
        the model's initial weights; returns the file loaded, or None."""
        h = self.hparams
        model_dir = run_dirs(h, create=False)["model"]
        path = Path(weights) if weights else _select_weights(h, model_dir)
        # an explicit file or initial_model_infer names one checkpoint:
        # averaging must not override it
        explicit = weights is not None or bool(h.get("initial_model_infer"))
        soup = None
        if h.get("average_checkpoints") and not explicit:
            soup = sorted(model_dir.glob("best_state_top*.msgpack")) or [
                p for p in sorted(model_dir.glob("best_state_top*"))
                if p.is_dir()]
        if soup:
            if h.get("use_ema"):
                print("[WARN] use_ema is ignored when average_checkpoints "
                      "averaging applies — serving the top-k soup of RAW "
                      "weights (disable one of the two)")
            self._set_state(average_checkpoints(soup, self._state()))
            print(f"[INFO] averaged {len(soup)} checkpoints: "
                  f"{[p.name for p in soup]}")
            return soup[0]
        if path is None or not path.exists():
            print("[WARN] no weights found — using random initialization")
            return None
        if path.suffix == ".pt":
            state = torch.load(path, map_location="cpu", weights_only=True)
            self.model.load_state_dict(state, strict=True)
            print(f"[INFO] loaded weights: {path}")
            return path
        loaded = None
        if h.get("use_ema"):
            loaded = load_ema_params(path, self._state())
            if loaded is None:
                print("[WARN] use_ema: checkpoint carries no EMA state "
                      "(train with optimizer.ema_decay); serving raw weights")
            else:
                print(f"[INFO] loaded EMA weights: {path}")
        if loaded is None:
            loaded = load_params_only(path, self._state())
            print(f"[INFO] loaded weights: {path}")
        self._set_state(loaded)
        return path

    def _state(self) -> dict:
        """The model's weights as flax ``params``/``batch_stats`` trees."""
        params, stats = params_to_jax(self.model.state_dict())
        return {"params": params, "batch_stats": stats}

    def _set_state(self, state: Mapping) -> None:
        self.model.load_state_dict(params_from_jax(
            state["params"], state["batch_stats"], like=self.model))

    def _wire(self, waves) -> np.ndarray:
        waves = np.asarray(waves)
        if self._transport == "int16" and waves.dtype != np.int16:
            # 16-bit PCM on the host→device wire: half the float32 bytes;
            # WAV-decoded crops sit on the 1/32768 grid, so it is lossless
            # for them
            waves = np.clip(np.round(waves * 32768.0),
                            -32768, 32767).astype(np.int16)
        return waves

    def _calibrate(self, waves: np.ndarray) -> None:
        """Static int8 scales from an evenly spaced subsample of this
        batch (eval lists are often speaker-ordered), then the int8
        embed fn."""
        flat = torch.as_tensor(waves).to(self.device)
        flat = flat.reshape(-1, flat.shape[-1])
        if flat.dtype == torch.int16:
            flat = flat.float() * (1.0 / 32768.0)
        n_calib = min(int(self.hparams.get("quant_calib_utts", 32)),
                      flat.shape[0])
        idx = np.linspace(0, flat.shape[0] - 1, n_calib).astype(int)
        model = (self.model if self._compute_dtype is None
                 else cast_copy(self.model, self._compute_dtype))
        self.act_scales = calibrate_act_scales(
            model, flat[torch.as_tensor(idx, device=self.device)])
        self._embed = make_int8_embed_fn(
            self.model, normalize=self._normalize,
            compute_dtype=self._compute_dtype, act_scales=self.act_scales)
        print(f"[INFO] int8: calibrated {len(self.act_scales)} activation "
              f"scales on {n_calib} utterances (+10% headroom)")

    def embed_fn(self, waves) -> torch.Tensor:
        """``waves [B, T]`` (numpy float32 or int16) → ``[B, D]`` fp32
        embeddings on the engine's device. An int8 engine calibrates on
        its first call."""
        waves = self._wire(waves)
        if self._embed is None:
            self._calibrate(waves)
        return self._embed(waves)

    def warm_up(self, waves) -> None:
        """Run ``waves`` through the float path and, on CUDA, build the
        int8 kernel: kernels built and memory allocated before traffic.
        An int8 engine does not calibrate here; a batch of silence would
        set its scales."""
        if self._embed is None and self.device.type == "cuda":
            quant_matmul.build()
        self._float_embed(self._wire(waves))

    def _cohorts(self) -> Optional[np.ndarray]:
        h = self.hparams
        if h.get("scoring_mode", "cosine") in ("norm", "zt_norm"):
            return np.load(str(h["cohorts_path"]))
        return None

    def evaluate(self, listfile: Optional[str] = None,
                 distributed: Optional[bool] = None) -> dict:
        """Score ``evaluation_file``: EER, AUC, minDCF and thresholds; writes
        ``evaluation_results.csv``, the false-accept/false-reject pair
        lists and a line of ``Inference_log.txt`` under the run's
        ``result`` directory. ``distributed`` (default: when several
        processes run) splits the files over the processes, each of
        which must call it; rank 0 writes."""
        if distributed is None:
            distributed = is_multiprocess()
        h = self.hparams
        listfile = listfile or h["evaluation_file"]
        mode = h.get("scoring_mode", "cosine")
        cohorts = self._cohorts()
        t0 = time.time()
        scores, labels, trials = evaluate_from_list(
            self.embed_fn, listfile, h["audio_spec"],
            num_eval=int(h.get("num_eval", 10)), scoring_mode=mode,
            cohorts=cohorts, normalize=False,
            batch_size=int(h.get("eval_batch_size", 32)),
            num_workers=int(h.get("dataloader_options", {})
                            .get("num_workers", 8)),
            distributed=distributed)
        elapsed = time.time() - t0

        res = tune_threshold_from_score(scores, labels, [1, 0.1])
        fnrs, fprs, thresholds = compute_error_rates(scores, labels)
        dcf = h.get("dcf", {}) or {}
        mindcf, dcf_thr = compute_min_dcf(
            fnrs, fprs, thresholds,
            p_target=float(dcf.get("dcf_p_target", 0.05)),
            c_miss=float(dcf.get("dcf_c_miss", 1)),
            c_fa=float(dcf.get("dcf_c_fa", 1)))

        result_dir = self.dirs["result"]
        if not is_main():
            # several processes: the embeddings were gathered on every
            # rank, and rank 0 writes the results
            return {"eer": res["roc"][1], "min_dcf": mindcf,
                    "threshold": res["roc"][3], "n_trials": len(scores)}
        with open(result_dir / "evaluation_results.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["label", "score", "trial"])
            for s, l, t in zip(scores, labels, trials):
                w.writerow([int(l), float(s), t])
        fafr = dump_fa_fr_pairs(scores, labels, trials, res["roc"][3],
                                result_dir)
        report = {
            "eer": res["roc"][1], "auc": res["roc"][2],
            "threshold": res["roc"][3], "min_dcf": mindcf,
            "dcf_threshold": dcf_thr, "gmean": res["gmean"][1],
            "n_trials": len(scores), "seconds": elapsed, **fafr,
        }
        with open(result_dir / "Inference_log.txt", "a") as f:
            f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} eval {listfile} "
                    f"-> EER {report['eer']:.4f}% minDCF {mindcf:.4f} "
                    f"thr {report['threshold']:.4f} ({elapsed:.1f}s)\n")
        print(f"[RESULT] EER {report['eer']:.4f}%  minDCF {mindcf:.4f}  "
              f"AUC {report['auc']:.4f}  thr {report['threshold']:.4f}")
        return report

    def test(self, listfile: Optional[str] = None,
             threshold: Optional[float] = None) -> dict:
        """Decisions on ``verification_file`` at ``test_threshold``; a
        threshold of 0 is first tuned on ``evaluation_file``. Writes
        ``<list>_results.txt`` and, for a labeled list, appends the
        classification report to ``Testing_log.txt``."""
        h = self.hparams
        listfile = listfile or h["verification_file"]
        threshold = threshold if threshold is not None else \
            float(h.get("test_threshold", 0))
        if threshold == 0:
            threshold = float(self.evaluate(distributed=False)["threshold"])
        out = self.dirs["result"] / (Path(listfile).stem + "_results.txt")
        scores, preds, labels = test_from_list(
            self.embed_fn, listfile, h["audio_spec"], threshold,
            num_eval=int(h.get("num_eval", 10)),
            scoring_mode=h.get("scoring_mode", "cosine"),
            cohorts=self._cohorts(), normalize=False, output_file=str(out))
        report = {"threshold": threshold, "n": len(scores),
                  "accept_rate": float(np.mean(preds)), "output": str(out)}
        if labels is not None and len(labels):
            report["accuracy"] = float(np.mean(preds == labels))
            report["fbeta"] = {b: fbeta_score(labels, preds, b)
                               for b in (0.5, 2)}
            cls_report = classification_report(labels, preds,
                                               ["Label '0'", "Label '1'"])
            with (self.dirs["result"] / "Testing_log.txt").open("a") as f:
                f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} thr "
                        f"{threshold}\n{cls_report}\n")
            print(cls_report)
        print(f"[RESULT] test: {report}")
        return report

    def prepare(self, prepare_type: Optional[str] = None):
        """``cohorts`` (the YAML key ``prepare``'s default): the cohort
        bank of ``train_annotation`` at ``cohorts_path``; ``embed``: the
        enrollment bank of ``data_folder``'s speaker folders as
        ``embeds.npy``/``classes.npy`` in the run's model directory."""
        h = self.hparams
        prepare_type = prepare_type or h.get("prepare", "cohorts")
        if prepare_type == "cohorts":
            return prepare_cohorts(
                self.embed_fn, h["train_annotation"], h["audio_spec"],
                num_eval=int(h.get("num_eval", 10)),
                save_path=str(h.get("cohorts_path", "cohorts.npy")))
        if prepare_type == "embed":
            return prepare_embeddings(
                self.embed_fn, h["data_folder"], h["audio_spec"],
                num_eval=int(h.get("num_eval", 10)),
                save_dir=str(self.dirs["model"]))
        raise ValueError(f"unknown prepare type {prepare_type!r}")

    def predict(self, files, threshold: float = 0.0):
        """The nearest enrolled speaker of each file, against the bank
        ``prepare('embed')`` wrote: ``(names, scores)``."""
        h = self.hparams
        embeds = np.load(self.dirs["model"] / "embeds.npy")
        classes = np.load(self.dirs["model"] / "classes.npy",
                          allow_pickle=True).item()
        return predict_identity(self.embed_fn, files, embeds, classes,
                                h["audio_spec"],
                                num_eval=int(h.get("num_eval", 10)),
                                threshold=threshold)


def inference(hparams: Mapping, eval_: bool = False, test: bool = False,
              prepare: bool = False, predict=None, device=None) -> dict:
    """CLI-facing dispatcher, in the JAX order: prepare, eval, test,
    predict (``predict``: a list of files, empty for none). With several
    processes every rank takes part in ``eval`` (the files are split
    over them); rank 0 alone runs the other verbs."""
    engine = InferenceEngine(hparams, device=device)
    out = {}
    main = is_main()
    if prepare and main:
        engine.prepare()
        out["prepared"] = True
    if is_multiprocess():
        torch.distributed.barrier()      # what prepare wrote is there
    if eval_:
        out["eval"] = engine.evaluate()
    if not main:
        return out
    if test:
        out["test"] = engine.test()
    if predict:
        names, scores = engine.predict(predict)
        out["predict"] = list(zip(names, [float(s) for s in scores]))
    return out
