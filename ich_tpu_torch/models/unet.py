"""The U-Net family (counterpart of :mod:`ich_tpu.models.unet`): the 2D/3D
``UNet``, the encoder with an MLP head (``UNetEncoder``, global contrastive
pretraining) and the encoder with the first decoder stages and a 1x1-conv
head (``PartialUNet``, local contrastive pretraining).

Channels-first. Submodules carry the reference torch networks'
``state_dict`` keys (``down_block.{i}``, ``bottleneck_block``,
``up_samp.{i}``, ``up_block.{i}``, ``final_conv``, ``mlp_head.fc_layers.{i}``,
``final_conv.conv_layers.{i}``), so ``ich_tpu.interop.torch_port``'s
``port_unet`` / ``port_unet_encoder`` / ``port_partial_unet`` map a port
``state_dict`` to the JAX package's variables unchanged, and a pretrained
encoder or partial net moves into a ``UNet`` by key intersection
(:func:`ich_tpu_torch.train.checkpoint.transfer_weights`).

``dtype`` is the compute dtype, as the JAX package's ``UNet(dtype=...)``:
the input is cast to it, parameters stay float32 and are cast at use
(:mod:`ich_tpu_torch.models.layers`), and the final 1x1 conv's output is
cast to float32 before the sigmoid or softmax.

``remat=True`` checkpoints every ``ConvBlock`` (:class:`ich_tpu_torch.models.
layers.ConvBlock`), as the JAX package's ``UNet(remat=True)`` wraps each in
``nn.remat``: activations inside a block are recomputed in the backward pass
instead of stored. The ``state_dict`` keys do not change.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ich_tpu_torch.models.layers import (
    _CONV,
    ConvBlock,
    ConvHead,
    MLPHead,
    max_pool,
    normalize_p_dropout,
    up_conv,
    upsample_linear,
)
from ich_tpu_torch.interop.from_jax import walk_partial_unet, walk_unet, walk_unet_encoder
from ich_tpu_torch.models.init import init_like_flax
from ich_tpu_torch.utils.config import NETWORKS


def _filter_plan(depth: int, top_filter: int) -> Tuple[list, int, list]:
    """Channels double per encoder level from ``top_filter``; the decoder
    halves them back."""
    down = [top_filter * (2**d) for d in range(depth - 1)]
    bottleneck = top_filter * (2 ** (depth - 1))
    up = [top_filter * (2 ** (d - 1)) for d in range(depth - 1, 0, -1)]
    return down, bottleneck, up


class _UNetBody(nn.Module):
    """The encoder (``depth - 1`` down blocks and the bottleneck) and the
    first ``n_decoder`` up stages (transposed conv or linear upsampling,
    then the skip concatenated first). Returns the last decoder stage's
    output (the bottleneck's with ``n_decoder == 0``) and the
    bottleneck."""

    def __init__(self, depth: int, ndim: int, bilinear: bool, in_channels: int,
                 top_filter: int, midchannels_factor: int,
                 p_dropout: Union[float, Sequence[float]], norm: str,
                 dtype: torch.dtype, remat: bool, n_decoder: int, gated: bool = False):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        self.ndim = ndim
        self.dtype = dtype
        self.bilinear = bilinear
        p_drop = normalize_p_dropout(p_dropout, depth)
        down, bottleneck, up = _filter_plan(depth, top_filter)

        self.down_block = nn.ModuleList()
        c = in_channels
        for i, ch in enumerate(down):
            self.down_block.append(ConvBlock(
                c, ch, ch // midchannels_factor, ndim=ndim, p_dropout=p_drop[i], norm=norm,
                remat=remat, gated=gated))
            c = ch
        self.bottleneck_block = ConvBlock(
            c, bottleneck, bottleneck // midchannels_factor, ndim=ndim,
            p_dropout=p_drop[-1], norm=norm, remat=remat, gated=gated)
        c = bottleneck
        self.up_samp = nn.ModuleList()
        self.up_block = nn.ModuleList()
        for i, ch in enumerate(up[:n_decoder]):
            if not bilinear:
                self.up_samp.append(up_conv(c, ch, ndim))
                c = ch
            self.up_block.append(ConvBlock(down[-1 - i] + c, ch, ch, ndim=ndim, norm=norm,
                                           remat=remat, gated=gated))
            c = ch
        self.out_channels_body = c

    def _body(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        skips = []
        for block in self.down_block:
            x = block(x)
            skips.append(x)
            x = max_pool(x, self.ndim)
        x = self.bottleneck_block(x)
        bottleneck = x
        for i, block in enumerate(self.up_block):
            x = upsample_linear(x, self.ndim) if self.bilinear else self.up_samp[i](x)
            x = block(torch.cat([skips[-1 - i], x], dim=1))
        return x, bottleneck


class UNet(_UNetBody):
    """U-Net with ``depth - 1`` down blocks, a bottleneck, ``depth - 1`` up
    stages and a final 1x1 conv with a float32 sigmoid (one class) or
    softmax. ``forward(x, return_bottleneck=True)`` also returns the
    bottleneck's features. ``gated=True`` makes every block's convs gated
    convs (:class:`ich_tpu_torch.models.layers.ConvBlock`), the attention
    U-Net's net; the keys stay the same. The weights are those flax's
    ``init`` draws from ``key`` for the JAX ``UNet``
    (:func:`ich_tpu_torch.models.init.init_like_flax`)."""

    _flax_walk = staticmethod(walk_unet)

    def __init__(self, depth: int = 5, ndim: int = 2, bilinear: bool = False,
                 in_channels: int = 1, out_channels: int = 1, top_filter: int = 64,
                 midchannels_factor: int = 2,
                 p_dropout: Union[float, Sequence[float]] = 0.5,
                 use_final_activation: bool = True, norm: str = "batch",
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 gated: bool = False, key: Optional[torch.Tensor] = None):
        super().__init__(depth, ndim, bilinear, in_channels, top_filter, midchannels_factor,
                         p_dropout, norm, dtype, remat, n_decoder=depth - 1, gated=gated)
        self.out_channels = out_channels
        self.use_final_activation = use_final_activation
        self.final_conv = _CONV[ndim](self.out_channels_body, out_channels, 1)
        init_like_flax(self, key)

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False):
        x, bottleneck = self._body(x)
        x = self.final_conv(x).to(torch.float32)
        if self.use_final_activation:
            x = torch.softmax(x, dim=1) if self.out_channels > 1 else torch.sigmoid(x)
        return (x, bottleneck) if return_bottleneck else x


class UNetEncoder(_UNetBody):
    """The encoder, a global average pool and an MLP projection head
    (``mlp_head`` lists each layer's output size), for global contrastive
    or classification pretraining. With ``return_bottleneck`` the pooled
    (B, C) features come second."""

    _flax_walk = staticmethod(walk_unet_encoder)

    def __init__(self, depth: int = 5, ndim: int = 2, mlp_head: Sequence[int] = (256, 128),
                 in_channels: int = 1, top_filter: int = 64, midchannels_factor: int = 2,
                 p_dropout: Union[float, Sequence[float]] = 0.5, norm: str = "batch",
                 dtype: torch.dtype = torch.float32, key: Optional[torch.Tensor] = None):
        super().__init__(depth, ndim, False, in_channels, top_filter, midchannels_factor,
                         p_dropout, norm, dtype, False, n_decoder=0)
        self.mlp_head = MLPHead(self.out_channels_body, mlp_head)
        init_like_flax(self, key)

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False):
        _, bottleneck = self._body(x)
        pooled = bottleneck.mean(dim=tuple(range(2, 2 + self.ndim)))
        out = self.mlp_head(pooled)
        return (out, pooled) if return_bottleneck else out


class PartialUNet(_UNetBody):
    """The encoder, the first ``n_decoder`` decoder stages and a 1x1-conv
    projection head (``head_channel`` lists each conv's output channels),
    for local contrastive pretraining (Chaitanya 2020)."""

    _flax_walk = staticmethod(walk_partial_unet)

    def __init__(self, depth: int = 5, n_decoder: int = 3, ndim: int = 2,
                 bilinear: bool = False, head_channel: Sequence[int] = (64, 32),
                 in_channels: int = 1, top_filter: int = 64, midchannels_factor: int = 2,
                 p_dropout: Union[float, Sequence[float]] = 0.5, norm: str = "batch",
                 dtype: torch.dtype = torch.float32, key: Optional[torch.Tensor] = None):
        super().__init__(depth, ndim, bilinear, in_channels, top_filter, midchannels_factor,
                         p_dropout, norm, dtype, False, n_decoder=n_decoder)
        self.final_conv = ConvHead(self.out_channels_body, head_channel, ndim)
        init_like_flax(self, key)

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False):
        x, bottleneck = self._body(x)
        out = self.final_conv(x)
        return (out, bottleneck) if return_bottleneck else out


# the reference configs' network names (``use_3D`` selects the rank)
NETWORKS.add("UNet", lambda use_3D=False, **kw: UNet(ndim=3 if use_3D else 2, **kw))
NETWORKS.add("UNet_Encoder", lambda use_3D=False, MLP_head=(256, 128), **kw: UNetEncoder(
    ndim=3 if use_3D else 2, mlp_head=tuple(MLP_head), **kw))
NETWORKS.add("Partial_UNet", lambda use_3D=False, head_channel=(64, 32), **kw: PartialUNet(
    ndim=3 if use_3D else 2, head_channel=tuple(head_channel), **kw))

# the attention U-Net: two input channels (image and anomaly map) by default
NETWORKS.add("GatedUNet", lambda use_3D=False, in_channels=2, **kw: UNet(
    ndim=3 if use_3D else 2, in_channels=in_channels, gated=True, **kw))
