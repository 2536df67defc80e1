"""2D/3D U-Net (counterpart of :class:`ich_tpu.models.unet.UNet`).

Channels-first. Submodules carry the reference torch network's
``state_dict`` keys (``down_block.{i}``, ``bottleneck_block``,
``up_samp.{i}``, ``up_block.{i}``, ``final_conv``), so
``ich_tpu.interop.torch_port.port_unet`` maps a port ``state_dict`` to the
JAX package's variables unchanged.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn

from ich_tpu_torch.models.layers import (
    _CONV,
    ConvBlock,
    max_pool,
    normalize_p_dropout,
    up_conv,
    upsample_linear,
)


def _filter_plan(depth: int, top_filter: int) -> Tuple[list, int, list]:
    """Channels double per encoder level from ``top_filter``; the decoder
    halves them back."""
    down = [top_filter * (2**d) for d in range(depth - 1)]
    bottleneck = top_filter * (2 ** (depth - 1))
    up = [top_filter * (2 ** (d - 1)) for d in range(depth - 1, 0, -1)]
    return down, bottleneck, up


class UNet(nn.Module):
    """U-Net with ``depth - 1`` down blocks, a bottleneck, ``depth - 1`` up
    stages (transposed conv or linear upsampling, then the skip concatenated
    first) and a final 1x1 conv with a float32 sigmoid (one class) or
    softmax."""

    def __init__(self, depth: int = 5, ndim: int = 2, bilinear: bool = False,
                 in_channels: int = 1, out_channels: int = 1, top_filter: int = 64,
                 midchannels_factor: int = 2,
                 p_dropout: Union[float, Sequence[float]] = 0.5,
                 use_final_activation: bool = True, norm: str = "batch"):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        self.ndim = ndim
        self.bilinear = bilinear
        self.out_channels = out_channels
        self.use_final_activation = use_final_activation
        p_drop = normalize_p_dropout(p_dropout, depth)
        down, bottleneck, up = _filter_plan(depth, top_filter)

        self.down_block = nn.ModuleList()
        c = in_channels
        for i, ch in enumerate(down):
            self.down_block.append(ConvBlock(
                c, ch, ch // midchannels_factor, ndim=ndim, p_dropout=p_drop[i], norm=norm))
            c = ch
        self.bottleneck_block = ConvBlock(
            c, bottleneck, bottleneck // midchannels_factor, ndim=ndim,
            p_dropout=p_drop[-1], norm=norm)
        c = bottleneck
        self.up_samp = nn.ModuleList()
        self.up_block = nn.ModuleList()
        for i, ch in enumerate(up):
            if not bilinear:
                self.up_samp.append(up_conv(c, ch, ndim))
                c = ch
            self.up_block.append(ConvBlock(down[-1 - i] + c, ch, ch, ndim=ndim, norm=norm))
            c = ch
        self.final_conv = _CONV[ndim](c, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for block in self.down_block:
            x = block(x)
            skips.append(x)
            x = max_pool(x, self.ndim)
        x = self.bottleneck_block(x)
        for i, block in enumerate(self.up_block):
            x = upsample_linear(x, self.ndim) if self.bilinear else self.up_samp[i](x)
            x = block(torch.cat([skips[-1 - i], x], dim=1))
        x = self.final_conv(x).to(torch.float32)
        if self.use_final_activation:
            x = torch.softmax(x, dim=1) if self.out_channels > 1 else torch.sigmoid(x)
        return x
