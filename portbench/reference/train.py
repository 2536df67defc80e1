"""The plain training step: Dice loss, backward and Adam with L2 weight
decay (torch's ``Adam``, which is optax's ``add_decayed_weights`` then
``scale_by_adam``), in float32 with TF32 off, over a dict of parameters.
Also the comparisons of a program's steps with the reference's."""

from __future__ import annotations

import contextlib
import statistics
from typing import Callable, Dict, List

import torch

Tensor = torch.Tensor


@contextlib.contextmanager
def exact_fp32():
    """float32 convolutions and matrix products without TF32 inside."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def dice_terms(pred: Tensor, mask: Tensor, p: int = 2, alpha: float = 1.0,
               eps: float = 1.0) -> Tensor:
    """Each sample's Dice loss, ``1 - (2 sum(pm) + eps) / (sum(p^p) +
    sum(m^p) + eps)``, times ``alpha`` where the mask is empty; the loss
    is their mean."""
    b = pred.shape[0]
    pred, mask = pred.reshape(b, -1).float(), mask.reshape(b, -1).float()
    dl = 1.0 - (2.0 * (pred * mask).sum(1) + eps) / (
        (pred ** p).sum(1) + (mask ** p).sum(1) + eps)
    return torch.where(mask.sum(1) > 0, dl, alpha * dl)


class Adam:
    """torch's Adam step written out, L2 decay added to the gradient."""

    def __init__(self, params: Dict[str, Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Update ``params`` in place; returns the gradients as Adam took
        them (decay included)."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5) + self.eps
            p.sub_(self.lr / (1 - b1 ** self.t) * self.m[k] / denom)
        return taken


def lr_at(train: dict, steps_per_epoch: int, step: int) -> float:
    """The rate of step ``step`` (counted from 0) under the configuration's
    schedule, which decays once an epoch: the closed form of torch's
    scheduler stepped after each epoch."""
    name, kw = train["lr_scheduler"], train.get("lr_scheduler_kwargs", {})
    epoch = step // steps_per_epoch
    if name == "ExponentialLR":
        return train["lr"] * kw.get("gamma", 0.95) ** epoch
    if name == "ConstantLR":
        return train["lr"]
    raise ValueError(f"no reference for the schedule {name!r}")


def run_steps(weights: Dict[str, Tensor], buffers: Dict[str, Tensor], n: int,
              loss_of: Callable[[int, Dict[str, Tensor], Dict[str, Tensor]], Tensor],
              lr_of: Callable[[int], float], weight_decay: float) -> dict:
    """``n`` steps from ``weights`` and ``buffers`` (cloned): step ``s``'s
    loss is the mean of the per-sample terms ``loss_of(s, params,
    buffers)``, its rate ``lr_of(s)``. Returns the record of the steps as
    the program's is kept: the state before them, their losses, the first
    one's terms and gradients as Adam took them, and the state after."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    bufs = {k: v.clone() for k, v in buffers.items()}
    opt = Adam({k: v.detach() for k, v in params.items()}, lr_of(0), weight_decay)

    def state():
        return {**{k: v.detach().clone() for k, v in params.items()},
                **{k: v.clone() for k, v in bufs.items()}}

    start, losses = state(), []
    first_grads = terms = None
    for s in range(n):
        step_terms = loss_of(s, params, bufs)
        loss = step_terms.mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.lr = lr_of(s)
        taken = opt.step({k: v.detach() for k, v in params.items()},
                         dict(zip(params, grads)))
        losses.append(float(loss.detach()))
        if s == 0:
            terms, first_grads = step_terms.detach(), taken
        del loss, grads, step_terms, taken
    return {"start": start, "losses": losses, "terms": terms, "grads": first_grads,
            "after": state()}


def replay_adam(start: Dict[str, Tensor], grads: List[Dict[str, Tensor]],
                lr_of: Callable[[int], float]) -> tuple:
    """Adam from ``start`` over the gradients as a program's optimizer got
    them (decay already added), one set a step, at the rate ``lr_of(s)``.
    Returns the parameters before the last step and that step's change."""
    params = {k: start[k].detach().clone().float() for k in grads[0]}
    opt = Adam(params, lr_of(0), weight_decay=0.0)
    before = None
    for s, g in enumerate(grads):
        if s == len(grads) - 1:
            before = {k: v.clone() for k, v in params.items()}
        opt.lr = lr_of(s)
        opt.step(params, {k: v.float() for k, v in g.items()})
    return before, {k: params[k] - before[k] for k in params}


def _norm_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap of norms, against the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med) for k, r in ref.items()}


def _terms_gap(prog: Tensor, ref: Tensor) -> float:
    """Per-sample terms, each against the reference's or the median term,
    whichever is larger (infinite where the two batches differ in size)."""
    a, b = prog.float(), ref.float().to(prog.device)
    if a.shape != b.shape:
        return float("inf")
    return float(((a - b).abs() / torch.maximum(b.abs(), b.abs().median())).max())


def _norms(d: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in d.items()}


def compare(prog: dict, ref: dict, detail: bool = False) -> dict:
    """The numbers that judge a training cell's first steps from the seed
    (its ``limits`` name those compared):

    - ``loss_gap``: the largest relative gap of a step's loss, and
      ``loss1_gap`` the first step's, steady where the later steps carry
      the noise of a lower precision's first update;
    - ``grad_gap``: over the leaves, the largest gap between the norms of
      the program's and the reference's first gradients, against the
      reference's norm of that leaf or of the median leaf, whichever is
      larger;
    - ``change_gap``: the same for the norm of each leaf's change over the
      steps (each side's ``after`` less its own ``start``), over the
      leaves whose reference gradient is at least a thousandth of the
      median leaf's (a conv bias under a norm has a gradient of rounding
      alone, which Adam scales up to a full step), and every buffer
      (BatchNorm's running averages);
    - ``grad_gap_median`` and ``change_gap_median``: the median over the
      leaves of each gap, steady where one small leaf's gap swings from
      seed to seed;
    - ``terms_gap``: the first step's loss term by term, each sample's
      gap against the reference's term or the median term, whichever is
      larger (infinite where the two batches differ in size).

    ``detail`` adds each step's loss gap and the three worst leaves of
    each gap, for the look behind a reading."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    gnorm = _norms(ref["grads"])
    grad = _norm_gaps(_norms(prog["grads"]), gnorm)
    med = statistics.median(gnorm.values())
    keep = [k for k in ref["after"] if k not in gnorm or gnorm[k] >= 1e-3 * med]
    change = _norm_gaps(_norms({k: prog["after"][k] - prog["start"][k] for k in keep}),
                        _norms({k: ref["after"][k] - ref["start"][k] for k in keep}))
    out = {"loss_gap": max(loss), "loss1_gap": loss[0],
           "terms_gap": _terms_gap(prog["terms"], ref["terms"]),
           "grad_gap": max(grad.values()), "change_gap": max(change.values()),
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap_median": statistics.median(change.values())}
    if detail:
        def worst(d):
            return sorted(((round(v, 5), k) for k, v in d.items()), reverse=True)[:3]

        out["detail"] = {"loss_gaps": loss, "grad_worst": worst(grad),
                         "change_worst": worst(change), "excluded": sorted(set(gnorm) - set(keep))}
    return out


def compare_window(prog: dict, ref: dict) -> dict:
    """The window's first step, the reference's forward and backward from
    the program's own state at the window's start: ``window_loss_gap``,
    ``window_terms_gap``, ``window_grad_gap`` and ``window_grad_gap_median``,
    measured as their namesakes in :func:`compare`."""
    grad = _norm_gaps(_norms(prog["grads"]), _norms(ref["grads"]))
    return {"window_loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "window_terms_gap": _terms_gap(prog["terms"], ref["terms"]),
            "window_grad_gap": max(grad.values()),
            "window_grad_gap_median": statistics.median(grad.values())}


def compare_replay(start: Dict[str, Tensor], at_window: Dict[str, Tensor],
                   after_first: Dict[str, Tensor], grads: List[Dict[str, Tensor]],
                   lr_of: Callable[[int], float]) -> dict:
    """The program's optimizer against Adam over the program's own
    gradients (``grads``, every step's from the first through the window's
    first): ``stage_gap``, each parameter's change from ``start`` to the
    window's start (``at_window``), and ``update_gap``, its change over the
    window's first step (to ``after_first``), each the worst leaf's gap of
    norms as in :func:`compare`."""
    before, delta = replay_adam(start, grads, lr_of)
    stage = _norm_gaps(_norms({k: at_window[k] - start[k] for k in delta}),
                       _norms({k: before[k] - start[k] for k in delta}))
    update = _norm_gaps(_norms({k: after_first[k] - at_window[k] for k in delta}),
                        _norms(delta))
    return {"stage_gap": max(stage.values()), "update_gap": max(update.values())}
