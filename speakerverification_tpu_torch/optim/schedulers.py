"""LR schedules, reduce-on-plateau and early stopping (port of
``optim/schedulers.py``).

A schedule is a host-side function ``tick -> lr``: ``tick`` is the epoch
index for an ``'epoch'`` schedule and the global iteration for an
``'iteration'`` one. The trainer writes the result into the optimizer's
injected learning rate every step. ``cosine_annealinglr_pt`` is torch's
closed form, periodic past ``T_max``; ``cosine_annealinglr_cus`` clamps
at ``lr_min``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

from speakerverification_tpu_torch.registry import SCHEDULERS

__all__ = ["build_scheduler", "ReduceOnPlateau", "EarlyStopping"]

Schedule = Callable[[int], float]


@SCHEDULERS.register("steplr")
def steplr(lr: float, step_size: int = 10, lr_decay: float = 0.95,
           **kw) -> Tuple[Schedule, str]:
    """lr · lr_decay^(epoch // step_size), stepped per epoch
    (parity: torch StepLR via src/callbacks/torch_callbacks.py:65-71)."""
    def sched(epoch: int) -> float:
        return lr * lr_decay ** (epoch // step_size)
    return sched, "epoch"


@SCHEDULERS.register("cosine_annealinglr_pt")
def cosine_annealing(lr: float, T_max: int = 10000, eta_min: float = 1e-6,
                     **kw) -> Tuple[Schedule, str]:
    """Closed-form CosineAnnealingLR, stepped per iteration
    (parity: src/callbacks/torch_callbacks.py:21-24). torch's closed form
    is PERIODIC — past T_max the lr oscillates back up (the reference sets
    T_max to one epoch of iterations, src/trainer.py:70-71, so the lr
    cycles per epoch); clamping at eta_min would freeze training."""
    def sched(it: int) -> float:
        return eta_min + (lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * it / max(T_max, 1)))
    return sched, "iteration"


@SCHEDULERS.register("cosine_annealinglr_cus")
def cosine_annealing_cus(lr: float, T_max: int = 10000, lr_min: float = 1e-6,
                         **kw) -> Tuple[Schedule, str]:
    def sched(it: int) -> float:
        return lr_min + (lr - lr_min) * 0.5 * (
            1 + math.cos(min(it, T_max) / max(T_max, 1) * math.pi))
    return sched, "iteration"


@SCHEDULERS.register("cosine_annealing_warm_restarts")
def warm_restarts(lr: float, T_max: int = 10000, T_mult: int = 1,
                  eta_min: float = 0.0, **kw) -> Tuple[Schedule, str]:
    """SGDR (parity: src/callbacks/torch_callbacks.py:27-30, T_0 = T_max)."""
    T_0 = max(T_max, 1)

    def sched(it: int) -> float:
        if T_mult == 1:
            t_cur = it % T_0
            t_i = T_0
        else:
            n = int(math.log(it / T_0 * (T_mult - 1) + 1, T_mult)) if it > 0 else 0
            t_i = T_0 * T_mult ** n
            t_cur = it - T_0 * (T_mult ** n - 1) // (T_mult - 1)
        return eta_min + (lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t_cur / t_i))
    return sched, "iteration"


@SCHEDULERS.register("cycliclr")
def cyclic(lr: float, base_lr: float = 1e-8, max_lr: float = 1e-3,
           T_max: int = 10000, mode: str = "triangular2", gamma: float = 1.0,
           **kw) -> Tuple[Schedule, str]:
    """Cyclical LR (parity: src/callbacks/torch_callbacks.py:33-62;
    step_size_up = step_size_down = T_max // 2)."""
    step_size = max(T_max // 2, 1)

    def sched(it: int) -> float:
        cycle = math.floor(1 + it / (2 * step_size))
        x = abs(it / step_size - 2 * cycle + 1)
        amp = (max_lr - base_lr) * max(0.0, 1 - x)
        if mode == "triangular":
            scale = 1.0
        elif mode == "triangular2":
            scale = 1.0 / (2 ** (cycle - 1))
        elif mode == "exp_range":
            scale = gamma ** it
        else:
            raise ValueError(f"unknown cyclic mode {mode!r}")
        return base_lr + amp * scale
    return sched, "iteration"


def build_scheduler(name: str, lr: float, **kwargs) -> Tuple[Schedule, str]:
    """Returns ``(schedule, 'epoch'|'iteration')`` keyed by YAML callback
    name (parity: src/model.py:187-204)."""
    factory = SCHEDULERS.get(name)
    import inspect
    accepted = set(inspect.signature(factory).parameters)
    clean = {k: v for k, v in kwargs.items() if k in accepted}
    return factory(lr, **clean)


class ReduceOnPlateau:
    """Host-side plateau LR reduction.

    Parity: src/callbacks/reduceOnPlateau.py:4-36 (torch ReduceLROnPlateau,
    mode='min'). Call with the monitored loss each epoch; read ``.lr``.
    """

    def __init__(self, lr: float, patience: int = 5, min_lr: float = 1e-6,
                 factor: float = 0.95):
        self.lr = lr
        self.patience = patience
        self.min_lr = min_lr
        self.factor = factor
        self.best = math.inf
        self.num_bad = 0

    def __call__(self, val_loss: float) -> float:
        if val_loss < self.best:
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


class EarlyStopping:
    """Stop when the monitored loss stops improving.

    Parity target: src/callbacks/earlyStopping.py:4-33. Documented
    divergence: the reference never resets the bad-epoch counter when the
    loss improves (only the trainer resets it externally on a new best,
    src/trainer.py:158-160); here the counter resets on improvement —
    the standard early-stopping semantics and the trainer's net effect.
    """

    def __init__(self, patience: int = 15, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = None
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if self.best_loss is None:
            self.best_loss = val_loss
        elif self.best_loss - val_loss > self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
