"""Optimizer factory (counterpart of ``viscy_tpu/training/optimizers.py``):
AdamW with a WarmupCosine or Constant learning-rate schedule.

``torch.optim.AdamW`` plus a ``LambdaLR`` that reproduces
``optax.warmup_cosine_decay_schedule``: a linear warmup from ``lr *
warmup_multiplier`` to ``lr`` over ``warmup_steps``, then a cosine decay to
0 that ends at ``total_steps`` (the decay length includes the warmup). The
optimizer's k-th step uses the schedule at count k - 1, as optax reads its
count before incrementing it: ``LambdaLR`` sets ``lambda(0)`` at
construction and the trainer steps the scheduler after the optimizer.
Weight decay applies to every parameter it is given (no mask); eps is 1e-8.
Clipping (``optax.clip_by_global_norm`` and ``optax.clip``) is the
trainer's ``gradient_clip_val``, applied before the optimizer's step.
"""

from __future__ import annotations

import math
from typing import Iterable, Literal

import torch


def _grads(params: Iterable[torch.nn.Parameter]) -> list[torch.Tensor]:
    return [p.grad for p in params if p.grad is not None]


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place on the gradients of ``params``:
    with ``n`` the global L2 norm of all of them, every gradient becomes
    ``g`` if ``n < max_norm`` else ``(g / n) * max_norm``. (Unlike
    ``torch.nn.utils.clip_grad_norm_``, which scales by ``max_norm / (n +
    1e-6)``.) Returns ``n``; reads nothing back to the host."""
    grads = _grads(params)
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


@torch.no_grad()
def clip_by_value_(params: Iterable[torch.nn.Parameter], max_delta: float) -> None:
    """``optax.clip``: clamp every gradient of ``params`` to [-max_delta, max_delta]."""
    for g in _grads(params):
        g.clamp_(-max_delta, max_delta)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, warmup_multiplier: float):
    """``count -> learning rate`` of ``optax.warmup_cosine_decay_schedule(
    init_value=lr * warmup_multiplier, peak_value=lr, warmup_steps,
    decay_steps=total_steps, end_value=0)``."""
    init = lr * warmup_multiplier
    decay = total_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return (init - lr) * (1.0 - count / warmup_steps) + lr
        frac = min(count - warmup_steps, decay) / decay
        return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def configure_adamw_scheduler(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    schedule: Literal["WarmupCosine", "Constant"] = "Constant",
    total_steps: int = 10_000,
    warmup_steps: int | None = None,
    warmup_multiplier: float = 1e-3,
    weight_decay: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.999,
):
    """Build AdamW + its LR scheduler. Returns ``(optimizer, scheduler,
    schedule_fn)``; ``schedule_fn(count)`` is the learning rate at an optax
    count (what the trainer logs)."""
    if schedule == "WarmupCosine":
        if warmup_steps is None:
            warmup_steps = max(1, total_steps // 100)
        total_steps = max(total_steps, warmup_steps + 1)
        sched = warmup_cosine(lr, warmup_steps, total_steps, warmup_multiplier)
    elif schedule == "Constant":
        sched = lambda count: lr  # noqa: E731
    else:
        raise ValueError(f"Unknown schedule {schedule!r}")
    opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: sched(count) / lr)
    return opt, scheduler, sched
