"""Seeded initial weights, drawn by the benchmark (not by the program) on
the device in one large call, the final bias calibrated with the plain
reference so that about a tenth of the voxels score >= 0.5 (random
weights otherwise give an all-0 or all-1 mask, whose loss and Dice say
nothing; ``chip_smoke.py``'s ``_calibrate_final_bias``), and their load
into the program's net. What is drawn for each leaf, and which bias is
calibrated, is the net's (``nets/<arch>.py``)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

Tensor = torch.Tensor


def draw(shapes: Dict[str, tuple], init: Callable[[str, tuple, Tensor], Tensor],
         gen: torch.Generator, device) -> Dict[str, Tensor]:
    """One standard normal draw for every leaf of ``shapes`` (in its order,
    float32), each leaf's slice turned into its value by ``init(name,
    shape, z)``; keyed as ``shapes``."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        out[name] = init(name, shape, z[at:at + size].view(shape)).contiguous()
        at += size
    return out


@torch.no_grad()
def calibrate_bias(weights: Dict[str, Tensor], key: str, logits: Tensor) -> None:
    """Shift ``weights[key]`` by the 0.9 quantile of ``logits`` (the
    reference's, with those weights)."""
    weights[key] -= torch.quantile(logits.flatten()[::7].float(), 0.9)


def load_into(net: torch.nn.Module, weights: Dict[str, Tensor]) -> None:
    """Copy ``weights`` into ``net``'s parameters; every parameter has to
    be covered and shaped alike (its buffers keep their starting values)."""
    params = dict(net.named_parameters())
    missing = sorted(set(params) ^ set(weights))
    if missing:
        raise ValueError(f"weights and the program's net differ in {missing[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
