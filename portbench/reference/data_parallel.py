"""The plain data-parallel step: each rank of a ``torch.distributed`` group
runs the plain reference on its shard of the global batch, and

- BatchNorm's statistics are the global batch's: inside
  :class:`GlobalBatchStats`, a mean over the batch and spatial axes of a
  (B, C, H, W) tensor, which ``reference/unet.py``'s BatchNorm takes for
  its mean and its biased variance, is the local sum all-reduced over the
  global count, the all-reduce summing the gradient over the ranks in the
  backward;
- each parameter's gradient is the mean over the ranks
  (:func:`averaged`, an all-reduce in the backward);
- a rank's dropout masks are its rows of the global batch's: the words of
  the stream from its first element (:func:`philox_from`).

Each collective is ``torch.distributed``'s own; nothing of the program is
used. ``plant`` puts a fault into the step for the check to find:
``local_stats`` (BatchNorm over each rank's shard alone), ``summed`` (the
gradients summed, not averaged), ``shard_left_out`` (the last rank's
gradient left out of the mean, the mean over the others)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from portbench.reference import rng

PLANTS = ("local_stats", "summed", "shard_left_out")


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class GlobalBatchStats(TorchFunctionMode):
    """Inside it, ``x.mean([0, 2, 3])`` of a 4-D ``x`` is the mean over every
    rank's batch (equal shards)."""

    def __init__(self, group, world: int):
        super().__init__()
        self.group, self.world = group, world

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in (torch.Tensor.mean, torch.mean) and len(args) == 2 and not kwargs
                and args[0].dim() == 4 and list(args[1]) == [0, 2, 3]):
            x = args[0]
            count = x.numel() / x.shape[1] * self.world
            return _SumOverRanks.apply(x.sum((0, 2, 3)), self.group) / count
        return func(*args, **kwargs)


class _MeanOverRanks(torch.autograd.Function):
    """The identity; its backward makes the gradient the mean over the
    ranks (or the planted fault's)."""

    @staticmethod
    def forward(ctx, p, group, world, rank, plant):
        ctx.group, ctx.world, ctx.rank, ctx.plant = group, world, rank, plant
        return p.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.plant == "shard_left_out" and ctx.rank == ctx.world - 1:
            g.zero_()
        dist.all_reduce(g, group=ctx.group)
        div = {"summed": 1, "shard_left_out": ctx.world - 1}.get(ctx.plant, ctx.world)
        return g / div, None, None, None, None


def averaged(params: Dict[str, torch.Tensor], group, plant: Optional[str] = None):
    """``params`` through :class:`_MeanOverRanks`: a gradient taken with
    respect to ``params`` is its mean over the ranks."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    return {k: _MeanOverRanks.apply(v, group, world, rank, plant) for k, v in params.items()}


def philox_from(key, start: int, n: int, device) -> torch.Tensor:
    """Words ``start .. start + n - 1`` of XLA's Philox stream under the rbg
    ``key`` (:func:`portbench.reference.rng.philox_bits`), ``start`` a
    multiple of 4: the stream from block ``start / 4`` on is the stream
    under the key whose 64-bit counter words (k2, k3) are advanced by that
    many blocks."""
    k0, k1, k2, k3 = (int(k) & 0xFFFFFFFF for k in key)
    base = (k3 << 32 | k2) + start // 4
    if start % 4 or base >= 1 << 64:
        raise ValueError("the stream's offset has to be whole blocks within the counter's "
                         "low words")
    return rng.philox_bits((k0, k1, base & 0xFFFFFFFF, base >> 32), n, device)
