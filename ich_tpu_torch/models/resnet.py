"""The ResNet family (counterpart of :mod:`ich_tpu.models.resnet`): the
slice-triage classifier and anomaly-detection gate, ResNet-18/34/50/101/152
with a configurable number of input channels.

Channels-first, with the reference torch network's ``state_dict`` keys
(``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``,
``layer{s}.{b}.shortcut.{0,1}``, ``linear``), which
``ich_tpu.interop.torch_port.port_resnet`` maps to the JAX package's
variables. The stem is a 7x7 stride-2 conv with padding 3, BatchNorm, ReLU
and a 3x3 stride-2 max pool with padding 1; the features are the global
mean of the last stage. Convs have no bias; weights are drawn as flax's
initialisers draw them and BatchNorm updates its statistics as flax does
(:mod:`ich_tpu_torch.models.layers`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from ich_tpu_torch.interop.from_jax import walk_resnet
from ich_tpu_torch.models.init import init_like_flax
from ich_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear
from ich_tpu_torch.utils.config import NETWORKS


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)  # flax momentum 0.9


def _shortcut(in_channels: int, out_channels: int, stride: int) -> nn.Module:
    """A 1x1 conv and BatchNorm where the shape changes, else the identity."""
    if stride == 1 and in_channels == out_channels:
        return nn.Identity()
    return nn.Sequential(Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
                         _bn(out_channels))


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm and the residual; ``features`` output
    channels."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.shortcut = _shortcut(in_channels, features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(self.shortcut(x) + y)


class Bottleneck(nn.Module):
    """1x1, 3x3 (strided) and 1x1 convs with BatchNorm and the residual;
    ``4 * features`` output channels."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.shortcut = _shortcut(in_channels, out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(self.shortcut(x) + y)


class ResNet(nn.Module):
    """The stem, ``len(stage_sizes)`` stages of ``block`` (64 * 2**s
    features, stride 2 at the first block of every stage but the first),
    the global mean and a linear layer to ``num_classes`` logits.
    ``forward(x, return_features=True)`` also returns the (B, C) features.
    The weights are flax's ``init`` of the JAX ``ResNet`` from ``key``."""

    _flax_walk = staticmethod(walk_resnet)

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int], num_classes: int = 2,
                 in_channels: int = 1, key: Optional[torch.Tensor] = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        c = 64
        for s, n_blocks in enumerate(stage_sizes):
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(c, 64 * 2**s, stride=2 if s > 0 and b == 0 else 1))
                c = 64 * 2**s * block.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.linear = Linear(c, num_classes)
        init_like_flax(self, key)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for s in range(self.n_stages):
            x = getattr(self, f"layer{s + 1}")(x)
        feats = x.mean(dim=(2, 3))
        logits = self.linear(feats)
        return (logits, feats) if return_features else logits


def resnet18(num_classes: int = 2, **kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes=num_classes, **kw)


def resnet34(num_classes: int = 2, **kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes=num_classes, **kw)


def resnet50(num_classes: int = 2, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes=num_classes, **kw)


def resnet101(num_classes: int = 2, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes=num_classes, **kw)


def resnet152(num_classes: int = 2, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes=num_classes, **kw)


FACTORIES = {"ResNet18": resnet18, "ResNet34": resnet34, "ResNet50": resnet50,
             "ResNet101": resnet101, "ResNet152": resnet152}
for _name, _fn in FACTORIES.items():
    NETWORKS.add(_name, lambda num_classes=2, input_channels=1, fn=_fn, key=None, **kw: fn(
        num_classes=num_classes, in_channels=input_channels, key=key))
