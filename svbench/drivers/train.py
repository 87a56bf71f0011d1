"""Training steps back to back through the program's ``make_train_step``.

Set-up builds the model with its head, the optimizer and the train
state as the trainer does (``encoder_from_hparams(with_loss=True)``,
``optimizer_from_hparams``, ``create_train_state``), loads the seeded
weights, and makes ``distinct_batches`` seeded batches of
``speakers_per_batch`` distinct labels × ``crops_per_speaker`` crops in
device memory. The first three steps, through the same step function on
the first three batches, are the ones the reference follows from the
seeded weights; a few more warm up; then the window runs steps back to
back until its seconds are up and ends in a synchronise. The window's
first step is compared too: the reference takes it from the program's
state before it (weights, BatchNorm statistics, the optimizer's moments
and count), kept in set-up, and its result is kept in the window.

Traffic keys: ``speakers_per_batch``, ``crops_per_speaker``,
``distinct_batches``, ``warm_steps``."""

from __future__ import annotations

import copy
import gc
import time

import numpy as np
import torch

from svbench.harness import cells, compare, flops, roofline, seeded
from svbench.harness.core import Check, log
from svbench.harness.trace import Trace
from svbench.reference.models import adabelief_step, build_reference, no_tf32

__all__ = ["hparams", "run"]

KERNEL_TAGS = {"k1": "mel_kernel"}
CHECK_STEPS = 3


def hparams(run) -> dict:
    h = copy.deepcopy(run.cell.config["hparams"])
    if run.control:
        h.update(copy.deepcopy(cells.control(run.cell, h)["hparams"]))
    return h


def _moments(opt_state: dict):
    """The optimizer's state that holds its moments ``m`` and ``v`` and
    its ``count`` (AdaBelief's), wherever the state's dicts nest it; None
    when it has none."""
    if "m" in opt_state:
        return opt_state
    for v in opt_state.values():
        if isinstance(v, dict):
            found = _moments(v)
            if found is not None:
                return found
    return None


def _clone(tree, device=None) -> dict:
    return {k: v.detach().to(device, copy=True) for k, v in tree.items()}


def _snapshot(state) -> dict:
    """The program's state before a step, copied to the host: weights and
    BatchNorm statistics, the optimizer's moments and count."""
    opt = _moments(state.opt_state)
    return {"weights": _clone(state.model.state_dict(), "cpu"),
            "m": _clone(opt["m"], "cpu"), "v": _clone(opt["v"], "cpu"),
            "count": int(opt["count"])}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tree.items()}


def _faulty(step, fault: str, n_spk: int):
    """A fault for the tests and the limits' upper readings."""
    if fault == "half":
        def half(state, wave, label, lr):
            # half of the batch left out, the mean over the rest
            return step(state, wave[:n_spk // 2], label[:n_spk // 2], lr)
        return half
    if fault == "unchanged":
        def unchanged(state, wave, label, lr):
            # a step that returns its state unchanged
            saved = {k: p.detach().clone() for k, p in state.params.items()}
            opt, count = state.opt_state, state.step
            state, out = step(state, wave, label, lr)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(saved[k])
            state.opt_state, state.step = opt, count
            return state, out
        return unchanged
    raise ValueError(f"unknown fault {fault!r}")


def run(run) -> None:
    from speakerverification_tpu_torch.builder import (
        compute_dtype_from_hparams,
        encoder_from_hparams,
        optimizer_from_hparams,
    )
    from speakerverification_tpu_torch.ops import mel_frontend
    from speakerverification_tpu_torch.training.state import (
        create_train_state,
    )
    from speakerverification_tpu_torch.training.train_step import (
        make_train_step,
    )
    h = hparams(run)
    t = run.cell.traffic
    run.stage("imports")
    dev = torch.device(run.device)
    on_cuda = dev.type == "cuda"
    spec = h["audio_spec"]
    sr = int(spec["sample_rate"])
    crop = int(float(spec["sentence_len"]) * sr)
    n_spk, n_per = int(t["speakers_per_batch"]), int(t["crops_per_speaker"])
    nb = int(t["distinct_batches"])
    lr = float(h["lr"])
    opt = h.get("optimizer", {})
    wd, b1 = float(opt.get("weight_decay", 0.0)), float(opt.get("b1", 0.9))

    ref = build_reference(h, with_loss=True).to(dev)
    seeded_sd = seeded.seeded_state(ref, run.seed)
    flops_per_crop = (flops.train_flops(ref, crop, n_per) if run.trace
                      else None)
    del ref
    run.stage("seeded weights")
    model = encoder_from_hparams(h, with_loss=True).to(dev)
    tx = optimizer_from_hparams(h)
    state = create_train_state(model, tx, run.seed)
    model.load_state_dict(seeded_sd)
    weights = {k: v.cpu() for k, v in seeded_sd.items()}
    del seeded_sd
    step = make_train_step(model, tx,
                           compute_dtype=compute_dtype_from_hparams(h))
    if run.fault is not None:
        step = _faulty(step, run.fault, n_spk)

    run.stage("train state")
    gen = seeded.generator(run.seed * 4 + 1, dev)
    waves = 0.1 * torch.randn(nb, n_spk, n_per, crop, generator=gen,
                              device=dev)
    labels = torch.stack([
        torch.randperm(int(h["nClasses"]), generator=gen, device=dev)[:n_spk]
        for _ in range(nb)])

    run.stage("batches")
    # the first three steps, which the reference follows
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    losses = []
    for i in range(CHECK_STEPS):
        state, out = step(state, waves[i], labels[i], lr)
        losses.append(out["loss"].detach().float().clone())
        if i == 0:
            m1 = _moments(state.opt_state)["m"]
            g1 = _norms({k: m1[k] / (1.0 - b1) - wd * p0[k] for k in p0})
    d3 = _norms({k: p.detach() - p0[k] for k, p in state.params.items()})
    losses = [float(x) for x in losses]
    run.stage("three checked steps")
    del p0
    for i in range(int(t["warm_steps"])):
        state, _ = step(state, waves[(CHECK_STEPS + i) % nb],
                        labels[(CHECK_STEPS + i) % nb], lr)

    if on_cuda:
        torch.cuda.synchronize()
    run.stage("warm steps")
    if on_cuda:
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    k1_0 = mel_frontend.launches
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    window_losses = []
    first = CHECK_STEPS + int(t["warm_steps"])
    before = _snapshot(state)
    sync()
    with Trace(run.trace and on_cuda, sync) as tr:
        run.window_opens()
        t0 = time.perf_counter()
        n = 0
        while True:
            i = (first + n) % nb
            state, out = step(state, waves[i], labels[i], lr)
            window_losses.append(out["loss"].detach())
            if n == 0:
                # the first step's result, which the reference follows
                after = {"params": _clone(state.params),
                         "m": _clone(_moments(state.opt_state)["m"])}
            n += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        sync()
        t1 = time.perf_counter()
    run.trace_summary = tr.summary(KERNEL_TAGS)
    finite = torch.isfinite(torch.stack(window_losses).float()).cpu()
    run.attempted, run.failed = n, int((~finite).sum())
    crops = n_spk * n_per
    run.e2e["train_crops_per_s"] = n * crops / (t1 - t0)
    r = run.readings
    r["k1.launches"] = mel_frontend.launches - k1_0
    r["window_s"] = t1 - t0
    r["steps"] = n
    if on_cuda:
        peak_window = torch.cuda.max_memory_allocated()
        run.memory_peak_bytes = int(max(peak_setup, peak_window))
        r["device.peak_bytes"] = peak_window
    if flops_per_crop is not None:
        r["model.flops_per_step"] = flops_per_crop * crops
        r["model.peak"] = roofline.peak_for(cells.precision(h))
        n_fft = int(h.get("n_fft", 512))
        hop = int(round(float(spec["hop_len"]) * sr))
        r["k1.least_s"] = roofline.mel_frontend_least_s(
            crops, crop, n_fft, hop, int(h.get("n_mels", 80)))
    log(f"[train] {n} steps of {crops} crops in {t1 - t0:.3f} s: "
        f"{run.e2e['train_crops_per_s']:.3f} crops/s, losses of the first "
        f"steps {losses}")

    first3 = (waves[:CHECK_STEPS].clone(), labels[:CHECK_STEPS].clone())
    at = first % nb
    window = {"before": before, "after": after,
              "batch": (waves[at].clone(), labels[at].clone()),
              "loss": float(window_losses[0])}
    del state, step, model, tx, waves, labels, window_losses
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    check(run, h, weights, first3, losses, g1, d3, lr, wd, window, b1)


def check(run, h, weights, batches, losses, g1, d3, lr, wd, window,
          b1) -> None:
    """The reference's first three steps (TF32 off) from the same weights
    on the same batches, and its step from the program's state before the
    window's first step on that step's batch, compared with the
    program's."""
    with no_tf32():
        numbers = _check(run, h, weights, batches, losses, g1, d3, lr, wd)
        numbers.update(_check_window(run, h, window, lr, wd, b1))
    run.readings["numbers"] = numbers
    log(f"[train] numbers {numbers}")
    # the cell's file names the numbers compared, each with its limit
    run.checks += [Check(k, numbers[k], float(v))
                   for k, v in run.cell.limits.items()]


def _check_window(run, h, window, lr, wd, b1) -> dict:
    """One reference step from the program's state before the window's
    first step: the loss, the gradient (the program's worked out from its
    first moment before and after: ``(m1 - b1 m0) / (1 - b1)`` less the
    L2 term) and the parameters' change, leaf by leaf."""
    dev = torch.device(run.device)
    after = window["after"]
    before = {k: _clone(v, dev) if isinstance(v, dict) else v
              for k, v in window["before"].items()}
    ref = build_reference(h, with_loss=True).to(dev).train()
    ref.load_state_dict(before["weights"])
    params = dict(ref.named_parameters())
    p0 = {k: before["weights"][k] for k in params}
    loss = ref.loss_of(*window["batch"])
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    g_ref = _norms(grads)
    opt_state = {"t": before["count"]}
    for k in params:
        opt_state[("m", k)] = before["m"][k].clone()
        opt_state[("s", k)] = before["v"][k].clone()
    adabelief_step(params, grads, opt_state, lr, wd)
    d_ref = _norms({k: p.detach() - p0[k] for k, p in params.items()})
    g_got = _norms({k: (after["m"][k] - b1 * before["m"][k]) / (1.0 - b1)
                    - wd * p0[k] for k in params})
    d_got = _norms({k: after["params"][k] - p0[k] for k in params})
    gaps_g = compare.leaf_norm_gaps(g_got, g_ref)
    gaps_d = compare.leaf_norm_gaps(d_got, d_ref,
                                    compare.moving_leaves(g_ref))
    log(f"[train] window's first step: loss {window['loss']} against "
        f"{loss.item()}; worst gradient leaves {compare.worst(gaps_g)}; "
        f"worst change leaves {compare.worst(gaps_d)}")
    del ref, params, grads, opt_state
    return {
        "window_loss_gap": compare.loss_gap([window["loss"]], [loss.item()]),
        "window_grad_norm_gap": max(gaps_g.values()),
        "window_grad_norm_gap_median": float(np.median(
            list(gaps_g.values()))),
        "window_change_norm_gap": max(gaps_d.values()),
        "window_change_norm_gap_median": float(np.median(
            list(gaps_d.values()))),
    }


def _check(run, h, weights, batches, losses, g1, d3, lr, wd) -> dict:
    dev = torch.device(run.device)
    ref = build_reference(h, with_loss=True).to(dev).train()
    ref.load_state_dict(weights)
    params = dict(ref.named_parameters())
    p0 = {k: p.detach().clone() for k, p in params.items()}
    opt_state: dict = {}
    ref_losses = []
    for i in range(CHECK_STEPS):
        loss = ref.loss_of(batches[0][i], batches[1][i])
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        ref_losses.append(loss.item())
        if i == 0:
            g1_ref = _norms(grads)
        adabelief_step(params, grads, opt_state, lr, wd)
    d3_ref = _norms({k: p.detach() - p0[k] for k, p in params.items()})
    gaps_g = compare.leaf_norm_gaps(g1, g1_ref)
    moving = compare.moving_leaves(g1_ref)
    gaps_d = compare.leaf_norm_gaps(d3, d3_ref, moving)
    numbers = {
        "loss_gap": compare.loss_gap(losses, ref_losses),
        "loss_gap_first": compare.loss_gap(losses[:1], ref_losses[:1]),
        "grad_norm_gap": max(gaps_g.values()),
        "grad_norm_gap_median": float(np.median(list(gaps_g.values()))),
        "change_norm_gap": max(gaps_d.values()),
        "change_norm_gap_median": float(np.median(list(gaps_d.values()))),
    }
    log(f"[train] reference losses {ref_losses}")
    log(f"[train] worst gradient leaves {compare.worst(gaps_g)}")
    log(f"[train] worst change leaves {compare.worst(gaps_d)}")
    log(f"[train] left out of the change: "
        f"{sorted(set(g1_ref) - set(moving))}")
    del ref, params, p0, opt_state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return numbers
