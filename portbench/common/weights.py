"""Seeded initial weights, drawn by the benchmark (not by the program) on
the device in one large call, and the final bias calibrated with the
plain reference so that about a tenth of the voxels score >= 0.5 (random
weights otherwise give an all-0 or all-1 mask, whose loss and Dice say
nothing; ``chip_smoke.py``'s ``_calibrate_final_bias``)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import unet as ref_unet
from portbench.reference.train import exact_fp32


def make_weights(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """He-normal conv and transposed-conv kernels (a transposed conv's fan
    in: its input channels), zero conv biases, norm scales ``1 + 0.1 z``
    and shifts ``0.1 z``; float32, keyed as the program's ``state_dict``."""
    shapes = ref_unet.param_shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        v = z[at:at + size].view(shape)
        at += size
        if ".bn" in name:
            v = 1.0 + 0.1 * v if name.endswith(".weight") else 0.1 * v
        elif name.endswith(".bias"):
            v = torch.zeros_like(v)
        else:
            fan_in = shape[0] if name.startswith("up_samp") else v[0].numel()
            v = v * (2.0 / fan_in) ** 0.5
        out[name] = v.contiguous()
    return out


@torch.no_grad()
def calibrate_final_bias(weights: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
                         train: bool) -> None:
    """Shift ``final_conv.bias`` by the 0.9 quantile of the reference's
    logits on ``x`` (a (B, 1, *spatial) batch), in float32; ``train`` takes
    BatchNorm's batch statistics."""
    with exact_fp32():
        logits = ref_unet.forward(weights, x, cfg, train=train,
                                  running=ref_unet.running_stats(cfg, x.device), logits=True)
    q = torch.quantile(logits.flatten()[::7].float(), 0.9)
    weights["final_conv.bias"] -= q


def load_into(net: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``net``'s parameters; every parameter has to
    be covered and shaped alike (its buffers keep their starting values)."""
    params = dict(net.named_parameters())
    missing = sorted(set(params) ^ set(weights))
    if missing:
        raise ValueError(f"weights and the program's net differ in {missing[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
