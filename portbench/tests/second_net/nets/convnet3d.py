"""A small 3D encoder-decoder (``reference/convnet3d.py``) built from the
program's layers: what a driver needs of it."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.common import weights
from portbench.common.flops import forward_flops
from portbench.reference import convnet3d as ref
from portbench.reference.train import exact_fp32

forward = ref.forward
param_shapes = ref.param_shapes

TINY_PATCH = 16  # even: one stride-2 level


def tiny(cfg: dict) -> dict:
    """Nothing to cut."""
    return {}


def build(cfg: dict, device, dtype=None) -> torch.nn.Module:
    from ich_tpu_torch.models import layers

    f = cfg["filters"]

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = layers.ConvBlock(cfg["in_channels"], f, ndim=3, norm="group")
            self.down = layers.Conv3d(f, 2 * f, 2, stride=2)
            self.mid = layers.ConvBlock(2 * f, 2 * f, ndim=3, norm="group")
            self.up = layers.ConvTranspose3d(2 * f, f, 2, stride=2)
            self.head = layers.Conv3d(2 * f, 1, 1)

        def forward(self, x):
            s = self.stem(x)
            y = self.up(self.mid(self.down(s)))
            return torch.sigmoid(self.head(torch.cat([s, y], 1)).float())

    with torch.device(device):
        return Net().to(dtype or getattr(torch, cfg["compute_dtype"]))


def _init(name: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    if ".bn" in name:
        return 1.0 + 0.1 * z if name.endswith(".weight") else 0.1 * z
    if name.endswith(".bias"):
        return torch.zeros_like(z)
    return z * (2.0 / z[0].numel()) ** 0.5


def make_weights(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    return weights.draw(param_shapes(cfg), _init, gen, device)


@torch.no_grad()
def calibrate_final_bias(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
                         train: bool) -> None:
    with exact_fp32():
        logits = forward(w, x, cfg, train=train, logits=True)
    weights.calibrate_bias(w, "head.bias", logits)


def flops(cfg: dict, batch: int, spatial, train: bool) -> float:
    return forward_flops(lambda p, x: forward(p, x, cfg, train=train), param_shapes(cfg),
                         (batch, cfg["in_channels"]) + tuple(spatial), train)
