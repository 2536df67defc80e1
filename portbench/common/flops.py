"""The work a cell's unit needs, from the configuration's shapes alone:
FLOPs counted by ``FlopCounterMode`` over a net's plain reference on the
meta device (so a change to the program's kernels leaves the count
alone)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(forward: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
                  shapes: Dict[str, tuple], x_shape: tuple, train: bool) -> float:
    """FLOPs of ``forward(params, x)`` on meta tensors of ``shapes`` and
    ``x_shape``, with the backward of every parameter and activation where
    ``train``."""
    p = {k: torch.empty(s, device="meta", requires_grad=train) for k, s in shapes.items()}
    x = torch.empty(x_shape, device="meta")
    with FlopCounterMode(display=False) as counter:
        y = forward(p, x)
        if train:
            y.sum().backward()
    return float(counter.get_total_flops())
