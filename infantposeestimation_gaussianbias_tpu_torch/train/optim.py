"""Optimizer and learning-rate schedule.

Port of infantposeestimation_gaussianbias_tpu/train/optim.py on
``torch.optim``:
* AdamW, Adam or SGD with Nesterov momentum, with weight decay only on
  the weights of Linear and Conv2d layers (the JAX package's mask: leaves
  named ``kernel`` with ndim >= 2; biases, norms, the RPE tables and the
  head's two decode logits go without), as two parameter groups;
* linear warmup from ``warmup_lr`` over ``warmup_epochs``, then a
  multiplicative step decay at each milestone, stepped per iteration.  The
  schedule is evaluated at the update count before the increment, as
  optax does, so the first update uses ``lr(0) = warmup_lr``;
* an optional clip by global norm, written as ``optax.clip_by_global_norm``
  computes it (scale by max / norm, no epsilon), applied in train/state.py.

``torch.optim.AdamW`` decays by ``lr * wd * p`` before the Adam step and
optax's ``adamw`` adds ``wd * p`` to the update; both give
``p - lr * (adam + wd * p)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

Schedule = Callable[[int], float]


def make_lr_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                     milestones_steps: Tuple[int, ...], gamma: float
                     ) -> Schedule:
    """Linear warmup, then piecewise-constant decay:
    lr(t) = warmup + (base - warmup) * t / T for t < T, then
    base * gamma^(milestones passed).  Float32 arithmetic, as the JAX
    schedule's."""
    f32 = np.float32
    milestones = tuple(int(m) for m in milestones_steps)

    def schedule(step: int) -> float:
        t = f32(step)
        if step < warmup_steps:
            w = np.minimum(t / f32(max(warmup_steps, 1)), f32(1.0))
            return float(f32(warmup_lr) + f32(base_lr - warmup_lr) * w)
        decay = f32(1.0)
        for m in milestones:
            if step >= m:
                decay = decay * f32(gamma)
        return float(f32(base_lr) * decay)

    return schedule


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it takes weight decay: the ``weight`` of
    every Linear, Conv2d and ConvTranspose2d layer (the JAX package's
    kernels of two or more axes), nothing else."""
    decayed = {f"{name}.weight" if name else "weight"
               for name, m in model.named_modules()
               if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))}
    return {name: name in decayed for name, _ in model.named_parameters()}


def lr_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """The schedule of a Config's ``train`` section for epochs of
    ``steps_per_epoch`` steps."""
    t = cfg.train
    return make_lr_schedule(
        base_lr=t.lr,
        warmup_lr=t.warmup_lr,
        warmup_steps=t.warmup_epochs * steps_per_epoch,
        milestones_steps=tuple(m * steps_per_epoch for m in t.lr_milestones),
        gamma=t.lr_gamma)


def build_optimizer(cfg, model: nn.Module, steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer, schedule) from a Config.  The optimizer's lr is set from
    the schedule before every update (train/state.py)."""
    t = cfg.train
    schedule = lr_schedule(cfg, steps_per_epoch)
    mask = weight_decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if mask[n]],
         "weight_decay": t.weight_decay},
        {"params": [p for n, p in params.items() if not mask[n]],
         "weight_decay": 0.0},
    ]
    lr0 = schedule(0)
    name = t.optimizer.lower()
    if name == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=tuple(t.betas),
                                eps=1e-8)
    elif name == "adam":
        for g in groups:
            g["weight_decay"] = 0.0
        opt = torch.optim.Adam(groups, lr=lr0, betas=tuple(t.betas), eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(groups, lr=lr0, momentum=t.momentum,
                              nesterov=True)
    else:
        raise ValueError(f"Unknown optimizer {t.optimizer!r}")
    return opt, schedule
