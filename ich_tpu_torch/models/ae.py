"""Convolutional autoencoder of the anomaly-detection route (counterpart of
:mod:`ich_tpu.models.ae`; reference ``AE_net.py``).

The encoder is an in-conv (kernel ``k``, stride 1), ``n_conv`` stride-2
convs doubling the channels from ``latent_channels`` and a k3 stride-2
bottleneck conv, each followed by BatchNorm and ReLU, all with torch's
symmetric padding ``(k - 1) // 2``. The decoder mirrors it: a k2 stride-2
transposed conv from the bottleneck, then ``n_conv`` transposed convs of
kernel ``k - 1``, stride 2 and padding ``(k - 2) // 2`` halving the
channels (the JAX package's explicit flax padding ``k - 1 - p``), or with
``bilinear`` a corner-aligned x2 upsample followed by a conv (k3 from the
bottleneck, ``k`` after); then the out-conv, its BatchNorm and tanh.

Channels-first. Submodules carry the reference torch network's keys
(``encoder.in_conv.{0,1}``, ``encoder.conv_list.{i}.{0,1}``,
``encoder.bottelneck_conv.{0,1}`` with the reference's spelling, and the
``decoder.*`` counterparts, the bilinear decoder's conv and BatchNorm at
``1`` and ``2`` behind the upsample), so
``ich_tpu.interop.torch_port.port_ae`` maps a port ``state_dict`` to the
JAX package's variables. BatchNorm is the port's, with flax's momentum 0.9.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ich_tpu_torch.interop.from_jax import walk_ae
from ich_tpu_torch.models.init import init_like_flax
from ich_tpu_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d
from ich_tpu_torch.utils.config import NETWORKS


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)  # flax momentum 0.9


def _conv_bn_relu(conv: nn.Module, channels: int) -> nn.Sequential:
    return nn.Sequential(conv, _bn(channels), nn.ReLU())


class AEEncoder(nn.Module):
    def __init__(self, in_channels: int = 1, latent_channels: int = 64,
                 bottleneck_channels: int = 64, n_conv: int = 3, kernel_size: int = 5):
        super().__init__()
        k, p = kernel_size, (kernel_size - 1) // 2
        self.in_conv = _conv_bn_relu(Conv2d(in_channels, latent_channels, k, padding=p),
                                     latent_channels)
        self.conv_list = nn.ModuleList()
        c = latent_channels
        for i in range(n_conv):
            ch = latent_channels * 2 ** (i + 1)
            self.conv_list.append(_conv_bn_relu(Conv2d(c, ch, k, stride=2, padding=p), ch))
            c = ch
        self.bottelneck_conv = _conv_bn_relu(
            Conv2d(c, bottleneck_channels, 3, stride=2, padding=1), bottleneck_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        for block in self.conv_list:
            x = block(x)
        return self.bottelneck_conv(x)


class AEDecoder(nn.Module):
    def __init__(self, latent_channels: int = 64, bottleneck_channels: int = 64,
                 out_channels: int = 1, n_conv: int = 3, bilinear: bool = False,
                 kernel_size: int = 5):
        super().__init__()
        chans = [latent_channels * 2 ** (i + 1) for i in range(n_conv)][::-1]
        k = kernel_size

        def up(c_in: int, c_out: int, bottleneck: bool = False) -> nn.Sequential:
            if bilinear:
                kb = 3 if bottleneck else k
                return nn.Sequential(
                    nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
                    Conv2d(c_in, c_out, kb, padding=(kb - 1) // 2), _bn(c_out), nn.ReLU())
            if bottleneck:
                conv = ConvTranspose2d(c_in, c_out, 2, stride=2)
            else:
                conv = ConvTranspose2d(c_in, c_out, k - 1, stride=2, padding=(k - 2) // 2)
            return _conv_bn_relu(conv, c_out)

        self.bottelneck_conv = up(bottleneck_channels, chans[0], bottleneck=True)
        self.conv_list = nn.ModuleList()
        c = chans[0]
        for ch in chans:
            self.conv_list.append(up(c, ch // 2))
            c = ch // 2
        self.out_conv = nn.Sequential(Conv2d(c, out_channels, k, padding=(k - 1) // 2),
                                      _bn(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bottelneck_conv(x)
        for block in self.conv_list:
            x = block(x)
        return torch.tanh(self.out_conv(x))


class AENet(nn.Module):
    """Encoder and decoder; ``forward(x, return_bottleneck=True)`` also
    returns the bottleneck's features. The weights are flax's ``init`` of
    the JAX ``AENet`` from ``key``."""

    _flax_walk = staticmethod(walk_ae)

    def __init__(self, in_channels: int = 1, latent_channels: int = 64,
                 bottleneck_channels: int = 64, n_conv: int = 3, bilinear: bool = False,
                 kernel_size: int = 5, key: Optional[torch.Tensor] = None):
        super().__init__()
        self.encoder = AEEncoder(in_channels, latent_channels, bottleneck_channels, n_conv,
                                 kernel_size)
        self.decoder = AEDecoder(latent_channels, bottleneck_channels, in_channels, n_conv,
                                 bilinear, kernel_size)
        init_like_flax(self, key)

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False):
        z = self.encoder(x)
        out = self.decoder(z)
        return (out, z) if return_bottleneck else out


# the reference config's keys, ``bottelneck_channels`` spelled as there
NETWORKS.add(
    "AE_net",
    lambda in_channels=1, latent_channels=64, bottelneck_channels=64, n_conv=3,
    bilinear=False, kernel_size=5, key=None, **kw: AENet(
        in_channels=in_channels, latent_channels=latent_channels,
        bottleneck_channels=bottelneck_channels, n_conv=n_conv, bilinear=bilinear,
        kernel_size=kernel_size, key=key))
