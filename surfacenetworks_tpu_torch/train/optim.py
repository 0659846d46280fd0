"""Optimizers and the LR schedule (counterpart of ``surfacenetworks_tpu/train/optim.py``).

Each optimizer makes the same updates as its optax counterpart in the JAX
package:

* ``adam``: ``torch.optim.Adam``; weight decay is coupled L2 (added to the
  gradient before the moments), as ``optax.chain(add_decayed_weights(wd),
  adam(lr))`` does.
* ``adam(amsgrad=True)``: ``Amsgrad`` below, not ``torch.optim.Adam(amsgrad=
  True)``.  optax keeps the running maximum of the *bias-corrected* second
  moment, ``nu_max = max(nu_max, nu / (1 - b2^t))``; torch keeps the maximum
  of the raw moment and divides by ``1 - b2^t`` afterwards, so after a large
  gradient and a small one the two take other steps.
* ``sgd``: ``torch.optim.SGD(lr, momentum=0.9, weight_decay=1e-5)``, which is
  ``optax.chain(add_decayed_weights(1e-5), sgd(lr, momentum=0.9))``: torch's
  first momentum buffer is the gradient itself, as optax's trace is.

A schedule (``epoch_halving_schedule``) is read at the optimizer's own update
count before that count is incremented, as optax's ``scale_by_schedule``
does.  The count lives in each param group as ``schedule_count``, so it is
saved and restored with the optimizer's state and only with it;
``apply_schedule`` sets the groups' ``lr`` before each ``step()``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def epoch_halving_schedule(base_lr: float, steps_per_epoch: int, start_epoch: int = 0,
                           every: int = 10) -> Schedule:
    """LR x0.5 at each ``every``-epoch boundary after ``start_epoch`` (the
    first halving at the first such boundary)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        n = (epoch - start_epoch - 1) // every + 1 if epoch > start_epoch else 0
        return base_lr * 0.5**n

    return schedule


class Amsgrad(torch.optim.Optimizer):
    """AMSGrad as optax's ``scale_by_amsgrad`` computes it: ``mu`` and ``nu``
    as in Adam, ``nu_max = max(nu_max, nu / (1 - b2^t))``, update
    ``-lr * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)``.  ``weight_decay`` is
    coupled L2.  Per-parameter state: ``step``, ``exp_avg`` (mu),
    ``exp_avg_sq`` (nu) and ``nu_max``."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                    st["nu_max"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                mu = st["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
                nu = st["exp_avg_sq"].mul_(b2).add_(g * g, alpha=1 - b2)
                torch.maximum(st["nu_max"], nu / (1 - b2**t), out=st["nu_max"])
                p.add_((mu / (1 - b1**t)) / (st["nu_max"].sqrt() + group["eps"]), alpha=-group["lr"])
        return loss


def _lr0(lr: float | Schedule) -> float:
    return lr(0) if callable(lr) else lr


def _mark_scheduled(opt: torch.optim.Optimizer, lr: float | Schedule) -> torch.optim.Optimizer:
    if callable(lr):
        for g in opt.param_groups:
            g["schedule_count"] = 0
    return opt


def adam(params: Iterable[torch.nn.Parameter], lr: float | Schedule = 1e-3, weight_decay: float = 0.0,
         amsgrad: bool = False) -> torch.optim.Optimizer:
    """Adam (or optax's AMSGrad), betas 0.9 and 0.999, eps 1e-8, coupled L2
    weight decay; ``lr`` a number or a schedule (``apply_schedule``)."""
    if amsgrad:
        opt = Amsgrad(params, lr=_lr0(lr), weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=_lr0(lr), betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return _mark_scheduled(opt, lr)


def sgd(params: Iterable[torch.nn.Parameter], lr: float | Schedule = 1e-3, weight_decay: float = 1e-5,
        momentum: float = 0.9) -> torch.optim.SGD:
    """SGD with momentum and coupled L2 weight decay."""
    return _mark_scheduled(torch.optim.SGD(params, lr=_lr0(lr), momentum=momentum, weight_decay=weight_decay), lr)


def apply_schedule(opt: torch.optim.Optimizer, schedule: Schedule | None) -> None:
    """Before ``opt.step()``: each group's ``lr`` becomes ``schedule`` at the
    group's update count, and the count goes up by one.  No-op without a
    schedule."""
    if schedule is None:
        return
    for g in opt.param_groups:
        g["lr"] = schedule(g["schedule_count"])
        g["schedule_count"] += 1
