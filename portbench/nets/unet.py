"""The U-Net of the upstream ICH project (``ich_tpu_torch.models.unet.
UNet``), as the drivers need it: the program's net, the seeded weights and
the final bias's calibration, the plain reference (``reference/unet.py``),
the FLOPs, the bytes of the keyed dropout and the cut for a CPU test."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.common import weights
from portbench.common.flops import forward_flops
from portbench.reference import unet as ref
from portbench.reference.train import exact_fp32

forward = ref.forward
param_shapes = ref.param_shapes
dropout_paths = ref.dropout_paths
running_stats = ref.running_stats

TINY_PATCH = 16  # a tiny 3D cell's patch edge; the cut net halves it twice


def tiny(cfg: dict) -> dict:
    """What a CPU test changes in the net: three levels, and in 2D four
    filters at the top."""
    return {"depth": 3, **({"top_filter": 4} if cfg["ndim"] == 2 else {})}


def build(cfg: dict, device, dtype=None) -> torch.nn.Module:
    """The program's net on ``device``, computing in ``dtype`` (default:
    the configuration's ``compute_dtype``)."""
    from ich_tpu_torch.models.unet import UNet

    with torch.device(device):
        return UNet(depth=cfg["depth"], ndim=cfg["ndim"], top_filter=cfg["top_filter"],
                    midchannels_factor=cfg["midchannels_factor"], p_dropout=cfg["p_dropout"],
                    norm=cfg["norm"], dtype=dtype or getattr(torch, cfg["compute_dtype"]))


def _init(name: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    """He-normal conv and transposed-conv kernels (a transposed conv's fan
    in: its input channels), zero conv biases, norm scales ``1 + 0.1 z``
    and shifts ``0.1 z``."""
    if ".bn" in name:
        return 1.0 + 0.1 * z if name.endswith(".weight") else 0.1 * z
    if name.endswith(".bias"):
        return torch.zeros_like(z)
    fan_in = shape[0] if name.startswith("up_samp") else z[0].numel()
    return z * (2.0 / fan_in) ** 0.5


def make_weights(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Float32 weights drawn from ``gen``, keyed as the program's
    ``state_dict``."""
    return weights.draw(param_shapes(cfg), _init, gen, device)


@torch.no_grad()
def calibrate_final_bias(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
                         train: bool) -> None:
    """Shift ``final_conv.bias`` by the 0.9 quantile of the reference's
    logits on ``x`` (a (B, 1, *spatial) batch), in float32; ``train`` takes
    BatchNorm's batch statistics."""
    with exact_fp32():
        logits = forward(w, x, cfg, train=train, running=running_stats(cfg, x.device),
                         logits=True)
    weights.calibrate_bias(w, "final_conv.bias", logits)


def flops(cfg: dict, batch: int, spatial, train: bool) -> float:
    """FLOPs of the net's forward on (batch, 1, *spatial), with the
    backward of every parameter and activation where ``train``."""
    return forward_flops(
        lambda p, x: forward(p, x, cfg, train=train, running=running_stats(cfg, "meta")),
        param_shapes(cfg), (batch, cfg["in_channels"]) + tuple(spatial), train)


def dropout_bytes(cfg: dict, batch: int, spatial, itemsize: int = 4) -> int:
    """Bytes a train step's keyed dropout has to move: each encoder block's
    output read and its dropped copy written in the forward, the gradient
    read and written in the backward."""
    down, bott = ref.level_channels(cfg)
    elems = 0
    for level, ch in enumerate(down + [bott]):
        elems += batch * ch * math.prod(s // 2 ** level for s in spatial)
    return 4 * itemsize * elems
