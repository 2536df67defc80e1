"""The work a cell's unit needs, from the configuration's shapes alone:
convolution FLOPs counted by ``FlopCounterMode`` over the plain reference
net on the meta device (so a change to the program's kernels leaves the
count alone), and the bytes of the keyed dropout."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import unet as ref_unet


def net_flops(net_cfg: dict, batch: int, spatial, train: bool) -> float:
    """FLOPs of the net's forward on (batch, 1, *spatial), with the
    backward of every parameter and activation where ``train``."""
    p = {k: torch.empty(s, device="meta", requires_grad=train)
         for k, s in ref_unet.param_shapes(net_cfg).items()}
    x = torch.empty((batch, net_cfg["in_channels"]) + tuple(spatial), device="meta")
    with FlopCounterMode(display=False) as counter:
        y = ref_unet.forward(p, x, net_cfg, train=train,
                             running=ref_unet.running_stats(net_cfg, "meta"))
        if train:
            y.sum().backward()
    return float(counter.get_total_flops())


def dropout_bytes(net_cfg: dict, batch: int, spatial, itemsize: int = 4) -> int:
    """Bytes a train step's keyed dropout has to move: each encoder block's
    output read and its dropped copy written in the forward, the gradient
    read and written in the backward."""
    down, bott = ref_unet.level_channels(net_cfg)
    elems = 0
    for level, ch in enumerate(down + [bott]):
        elems += batch * ch * math.prod(s // 2 ** level for s in spatial)
    return 4 * itemsize * elems
