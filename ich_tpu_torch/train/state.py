"""Training state, learning-rate schedules and the optimizer (counterpart of
:mod:`ich_tpu.train.state`).

The schedules are the JAX package's closed forms of the step index, with
``steps_per_epoch`` baked in, so that they decay per epoch as the
reference's torch schedulers stepped once an epoch do; they are
registered in ``SCHEDULES`` under the torch names of the reference configs.
torch's own scheduler classes are not used: torch's ``ConstantLR`` scales
the rate by 1/3 for 5 steps where the reference configs mean a constant
rate, and its ``CosineAnnealingLR`` is recursive.

The optimizer is ``torch.optim.Adam`` with ``weight_decay`` as L2 added to
the gradient before the moments, which is optax's ``add_decayed_weights``
-> ``scale_by_adam`` chain (not AdamW).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from ich_tpu_torch.parallel.mesh import average_gradients
from ich_tpu_torch.utils.config import SCHEDULES


@SCHEDULES.register("ExponentialLR")
def exponential_lr(lr: float, steps_per_epoch: int, gamma: float = 0.95) -> Callable:
    def schedule(step):
        epoch = step // steps_per_epoch
        return lr * gamma**epoch

    return schedule


@SCHEDULES.register("StepLR")
def step_lr(lr: float, steps_per_epoch: int, step_size: int = 30, gamma: float = 0.1) -> Callable:
    def schedule(step):
        epoch = step // steps_per_epoch
        return lr * gamma ** (epoch // step_size)

    return schedule


@SCHEDULES.register("CosineAnnealingLR")
def cosine_lr(lr: float, steps_per_epoch: int, T_max: int = 50, eta_min: float = 0.0) -> Callable:
    def schedule(step):
        epoch = step // steps_per_epoch
        return eta_min + 0.5 * (lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max))

    return schedule


@SCHEDULES.register("ConstantLR")
def constant_lr(lr: float, steps_per_epoch: int) -> Callable:
    return lambda step: lr


@SCHEDULES.register("MultiStepLR")
def multistep_lr(lr: float, steps_per_epoch: int, milestones=(30, 80), gamma: float = 0.1) -> Callable:
    ms = tuple(sorted(milestones))

    def schedule(step):
        epoch = step // steps_per_epoch
        return lr * gamma ** sum(epoch >= m for m in ms)

    return schedule


def make_schedule(name: str, lr: float, steps_per_epoch: int, **kwargs: Any) -> Callable:
    return SCHEDULES.build(name, lr=lr, steps_per_epoch=steps_per_epoch, **kwargs)


def make_optimizer(
    params,
    lr: float,
    weight_decay: float = 0.0,
    betas: tuple = (0.9, 0.999),
    eps: float = 1e-8,
    grad_clip: Optional[float] = None,
) -> torch.optim.Adam:
    """torch ``Adam`` with L2 ``weight_decay`` (reference ``UNet2D.py:103``).
    ``grad_clip`` clips the gradients' global norm before each step, as
    optax's ``clip_by_global_norm`` first in the chain."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    if grad_clip is not None:
        def clip(optimizer, args, kwargs):
            nn.utils.clip_grad_norm_(params, grad_clip)

        opt.register_step_pre_hook(clip)
    return opt


@dataclasses.dataclass
class TrainState:
    """The network, its optimizer, the schedule and the number of steps
    taken. ``apply_gradients`` sets the rate of step ``step`` (the
    schedule's value at the count of earlier steps, as optax's
    ``scale_by_learning_rate``) and steps the optimizer. With a ``mesh``
    (:class:`ich_tpu_torch.parallel.Mesh`) the optimizer's gradients are
    first averaged over the ranks, so that every replica takes the same
    Adam step, the global batch's."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    mesh: Any = None

    def apply_gradients(self) -> None:
        if self.mesh is not None:
            with torch.profiler.record_function("grad_all_reduce"):
                average_gradients(
                    (p for g in self.optimizer.param_groups for p in g["params"]), self.mesh)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
