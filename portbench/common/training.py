"""What the two training cells share: the record of the steps that set-up
and the window take, the window that ends through the program's own
stop, and the judgement of the record."""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict

import torch

from portbench.reference.train import compare, compare_replay, compare_window, dice_terms

N_CHECKED = 3  # set-up's first steps that the reference follows from the seed


def _state(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every parameter and BatchNorm average of ``net``."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}


class Steps:
    """Records the steps that ``trainer`` takes through its own ``train``,
    from set-up's first (installed before it) through the window's first,
    step ``window`` (the number of set-up's steps), with nothing of its
    optimizer's implementation:

    - ``losses``: each step's loss (a wrapper around the trainer's loss
      function, which also counts the steps);
    - ``terms``: the per-sample Dice terms of the predictions and masks
      that loss was given (``loss_kwargs``: the configuration's ``p`` and
      ``alpha``), at step 0 and at step ``window``;
    - ``grads``: each step's gradients as the optimizer gets them, each
      parameter's accumulated gradient (a hook after accumulation) plus
      ``weight_decay`` times the parameter, L2 decay as torch's and optax's
      Adam add it;
    - ``at``: the parameters and BatchNorm averages as each of the steps
      0, ``n``, ``window`` and ``window + 1`` begins (a forward pre-hook),
      when every hook goes.
    """

    def __init__(self, trainer, loss_kwargs: dict, weight_decay: float, window: int,
                 n: int = N_CHECKED):
        if window <= n:
            raise ValueError("set-up's steps have to outnumber the steps checked from the seed")
        self.trainer, self.n, self.window = trainer, n, window
        net = trainer.unet
        self.at = {0: _state(net)}
        self.losses, self.terms, self.grads = [], {}, []
        self._loss = trainer.loss
        names = {id(p): k for k, p in net.named_parameters()}

        def loss(pred, mask):
            out = self._loss(pred, mask)
            s = len(self.losses)
            if s in (0, window):
                self.terms[s] = dice_terms(pred.detach(), mask, loss_kwargs["p"],
                                           loss_kwargs["alpha"])
            self.losses.append(out.detach().clone())
            self.grads.append({})
            return out

        def grad_hook(p):
            self.grads[-1][names[id(p)]] = p.grad.detach() + weight_decay * p.detach()

        def forward_pre_hook(module, args):
            s = len(self.losses)
            if s in (n, window, window + 1) and s not in self.at:
                self.at[s] = _state(module)
            if s == window + 1:
                self._uninstall()

        trainer.loss = loss
        self._handles = [p.register_post_accumulate_grad_hook(grad_hook)
                         for p in net.parameters() if p.requires_grad]
        self._handles.append(net.register_forward_pre_hook(forward_pre_hook))

    def _uninstall(self) -> None:
        self.trainer.loss = self._loss
        for h in self._handles:
            h.remove()
        self._handles = []

    def record(self) -> dict:
        """Uninstall, if the hooks are still in; returns the record: ``first``,
        set-up's first ``n`` steps as :func:`portbench.reference.train.
        compare` takes them; ``window``, the window's first step as
        :func:`compare_window` takes it; and ``at`` and ``grads`` for
        :func:`compare_replay`."""
        self._uninstall()
        w = self.window
        if w + 1 not in self.at:
            raise RuntimeError(f"the trainer took {len(self.losses)} steps; the check needs "
                               f"set-up's {w}, the window's first and the start of one more")
        losses = [float(x) for x in self.losses[:w + 1]]
        return {"first": {"start": self.at[0], "losses": losses[:self.n],
                          "terms": self.terms[0], "grads": self.grads[0],
                          "after": self.at[self.n]},
                "window": {"losses": losses[w:], "terms": self.terms[w],
                           "grads": self.grads[w]},
                "at": self.at, "grads": self.grads[:w + 1]}


def against(prog: dict, ref: dict, detail: bool = False) -> dict:
    """Set-up's first steps (``first``) against the reference's from the
    seed, and the window's first step (``window``) against the reference's
    from the program's state as the window began."""
    return {**compare(prog["first"], ref["first"], detail),
            **compare_window(prog["window"], ref["window"])}


def judge(record: dict, ref: dict, lr_of, detail: bool = False) -> dict:
    """Every number of a training cell's check: :func:`against`, and the
    program's optimizer against Adam over the program's own gradients at
    the schedule's rate ``lr_of``."""
    w = len(record["grads"]) - 1
    at = record["at"]
    return {**against(record, ref, detail),
            **compare_replay(at[0], at[w], at[w + 1], record["grads"], lr_of)}


def fit_window(trainer, dataset, seconds: float):
    """Train until ``seconds`` have passed, ending through the program's
    preemption path: a SIGTERM to this process after ``seconds``, upon
    which ``fit`` finishes the epoch under way and returns (set-up's warm
    epoch has installed the handler). Returns (steps, elapsed seconds);
    every step's work has ended when ``fit`` returns (it fetches each
    epoch's mean loss)."""
    from ich_tpu_torch.utils import preemption

    steps0 = trainer.state.step
    trainer.n_epoch = 1 << 30
    timer = threading.Timer(seconds, os.kill, (os.getpid(), signal.SIGTERM))
    t0 = time.perf_counter()
    timer.start()
    try:
        trainer.train(dataset)
    finally:
        timer.cancel()
    elapsed = time.perf_counter() - t0
    preemption.reset()
    return trainer.state.step - steps0, elapsed
