"""The train step (port of ``training/train_step.py::make_train_step``),
one device.

``step(state, wave, label, lr, rng=None, *aug_args) -> (state, {"loss",
"prec1"})``: the model's forward in training mode on ``wave [B,
nPerSpeaker, T]`` and ``label [B]``, the gradient of the loss with respect to the fp32 master
parameters (the wave is not one: the mel kernel needs no backward), the
optimizer update at learning rate ``lr``, and the BatchNorm running
statistics that the forward updated.

``rng`` is a ``torch.Generator`` on the step's device, given per step.
With ``augment_fn(wave, rng, *aug_args) -> wave`` set (on-device
augmentation: ``ops/device_augment.py``, ``ops/timeaugment.py``), the
whole batch is augmented first, in fp32 and without gradient, before any
microbatch split; the noise and RIR banks ride in ``aug_args``, so the
trainer can swap them per epoch. A model with SpecAugment or dropout
(the Conformer family) draws from the same generator in each
microbatch's forward, and raises when the step is given none (the JAX
step always passes a ``dropout`` key).

``compute_dtype=torch.bfloat16`` runs the forward and backward through
bf16 copies of the parameters (``torch.func.functional_call``), so the
gradients land in fp32 on the masters, as the JAX step casts its params;
the frontend stays fp32 and casts its features (the model's own
``compute_dtype``, set by ``builder.encoder_from_hparams``).

``accum_steps=k`` splits the batch into k microbatches run one after
another: each starts from the step's incoming batch statistics, the
gradients, losses and precisions are averaged over the k, and so are
the k microbatches' new statistics; one optimizer update follows.

With ``data_group`` (a ``torch.distributed`` process group: one process
per GPU, ``parallel/dp.py``) the gradients, the loss, the precision and
the BatchNorm running statistics are averaged over the group's ranks
before the update, as the JAX step ``pmean``s them over its data axis:
every rank then applies the same update, and each rank's BatchNorm
(which normalized its own shard) leaves the mean of the shards'
statistics. ``grad_scale`` multiplies the gradients first (the
class-sharded head's ``1 / n_model``, ``parallel/tp.py``).

On CUDA the step runs with ``torch.backends.cudnn.benchmark`` on
(:func:`timed_conv_plans`), as XLA autotunes the JAX step's convolutions.
:func:`eval_dp_devices` is the policy of row-split eval extraction
(``inference.make_eval_embed_fn(devices=...)``).

While a profiler runs (``utils/tracing.py``), a step is a ``train.step``
span holding a ``train.forward`` and a ``train.backward`` span for each
microbatch and one ``train.optimizer`` span, the three with CUDA events.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
from torch.func import functional_call

from speakerverification_tpu_torch.optim import (
    apply_updates,
    set_learning_rate,
)
from speakerverification_tpu_torch.parallel.collectives import (
    mean_over_group_,
)
from speakerverification_tpu_torch.training.state import TrainState
from speakerverification_tpu_torch.utils import tracing

__all__ = ["make_train_step", "timed_conv_plans", "eval_dp_devices"]


def eval_dp_devices(hparams) -> Optional[list]:
    """Every local GPU when more than one is visible and
    ``eval_data_parallel`` is not off, else None: the one policy of the
    trainer's validation and the inference engine."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > 1 and bool(hparams.get("eval_data_parallel", True)):
        return [torch.device("cuda", i) for i in range(n)]
    return None


@contextlib.contextmanager
def timed_conv_plans(device: torch.device) -> Iterator[None]:
    """On a CUDA ``device``, cuDNN picks each convolution's plan by timing
    the candidates (once per shape; PyTorch caches the pick). Untimed, its
    heuristic may take any plan whose workspace fits the allocator's
    free memory: in ``Raw_ECAPA_conv_asp``'s fp32 step that was an FFT
    weight gradient of a 3-tap conv over 131 steps, 157 ms and ~66 GiB of
    workspace, where other plans take a few ms."""
    cudnn = torch.backends.cudnn
    if device.type != "cuda":
        yield
        return
    was = cudnn.benchmark
    cudnn.benchmark = True
    try:
        yield
    finally:
        cudnn.benchmark = was


def make_train_step(model, tx, compute_dtype: Optional[torch.dtype] = None,
                    accum_steps: int = 1,
                    augment_fn: Optional[Callable] = None,
                    data_group=None, grad_scale: float = 1.0) -> Callable:
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def value_and_grads(state: TrainState, wave, label, rng):
        names = list(state.params)
        masters = [state.params[k] for k in names]
        with timed_conv_plans(wave.device):
            with tracing.span("train.forward", device=wave.device):
                if compute_dtype is None:
                    loss, prec1 = model(wave, label, rng)
                else:
                    cast = {k: p.to(compute_dtype) if p.is_floating_point()
                            else p for k, p in zip(names, masters)}
                    loss, prec1 = functional_call(
                        model, cast, (wave, label), {"rng": rng},
                        strict=False)
                loss = loss.float()
            with tracing.span("train.backward", device=wave.device):
                grads = torch.autograd.grad(loss, masters,
                                            allow_unused=True)
                # a parameter the loss does not reach gets a zero
                # gradient, as jax.grad gives it
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(masters, grads)]
        return loss.detach(), prec1.detach(), dict(zip(names, grads))

    def step(state: TrainState, wave: torch.Tensor, label: torch.Tensor,
             lr: float, rng: Optional[torch.Generator] = None, *aug_args):
        with tracing.span("train.step"):
            return _step(state, wave, label, lr, rng, *aug_args)

    def _step(state, wave, label, lr, rng, *aug_args):
        model.train()
        if augment_fn is not None:
            if rng is None:
                raise ValueError("a step with augment_fn needs a generator")
            with torch.no_grad():
                wave = augment_fn(wave.float(), rng, *aug_args)
        if accum_steps == 1:
            loss, prec1, grads = value_and_grads(state, wave, label, rng)
        else:
            k = accum_steps
            if wave.shape[0] % k:
                raise ValueError(
                    f"batch of {wave.shape[0]} speaker tuples does not "
                    f"split into accumulate_steps={k} microbatches")
            stats = list(state.batch_stats.values())
            incoming = [s.clone() for s in stats]
            s_acc = [torch.zeros_like(s, dtype=torch.float32)
                     for s in stats]
            grads, loss, prec1 = None, 0.0, 0.0
            n = wave.shape[0] // k
            for i in range(k):
                with torch.no_grad():
                    torch._foreach_copy_(stats, incoming)
                l_i, p_i, g_i = value_and_grads(
                    state, wave[i * n:(i + 1) * n], label[i * n:(i + 1) * n],
                    rng)
                grads = g_i if grads is None else {
                    key: grads[key] + g for key, g in g_i.items()}
                torch._foreach_add_(s_acc, stats)
                loss, prec1 = loss + l_i, prec1 + p_i
            inv = 1.0 / k
            grads = {key: g * inv for key, g in grads.items()}
            with torch.no_grad():
                torch._foreach_copy_(stats, torch._foreach_mul(s_acc, inv))
            loss, prec1 = loss * inv, prec1 * inv

        if grad_scale != 1.0:
            grads = {key: g * grad_scale for key, g in grads.items()}
        if data_group is not None:
            metrics = torch.stack([torch.as_tensor(loss).float(),
                                   torch.as_tensor(prec1).float()])
            mean_over_group_([*grads.values(), metrics,
                              *state.batch_stats.values()], data_group)
            loss, prec1 = metrics[0], metrics[1]

        with tracing.span("train.optimizer", device=wave.device):
            opt_state = set_learning_rate(state.opt_state, lr)
            params = {k: p.detach() for k, p in state.params.items()}
            updates, opt_state = tx.update(grads, opt_state, params)
            apply_updates(params, updates)
        state.opt_state = opt_state
        state.step += 1
        return state, {"loss": loss, "prec1": prec1}

    return step
