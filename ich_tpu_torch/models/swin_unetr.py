"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266), as MONAI's
``SwinUNETR`` defines it, for 3D segmentation of (B, C, D, H, W) patches.

The encoder is a Swin transformer over 2^3 patches of the input: a strided
conv embeds them (no norm), then four stages of two Swin blocks, each stage
ending in a patch merging that halves the resolution and doubles the
width. A block is windowed multi-head self-attention over 7^3 windows
(every second block's windows shifted by 3, with a shift mask), with a
learned relative position bias, then a GELU MLP, each behind a LayerNorm
and a residual. The embedding and each stage's output, LayerNorm'd without
affine, are the hidden states ``h0`` .. ``h4``. The decoder is UNETR's:
residual conv blocks (3^3 convs, InstanceNorm, LeakyReLU 0.01) on the
input and on ``h0`` .. ``h2`` and ``h4``, then five up blocks (a 2^3
stride-2 transposed conv, the skip concatenated after it, a residual
block) back to the input's resolution, and a 1^3 conv to the logits.

Per axis where a stage's resolution is at most the window, the window is
that resolution and the shift 0 (MONAI's ``get_window_size``). Windows are
zero-padded at the far end of each axis; padded tokens are not masked, as
in MONAI. Each pair of tokens in a window takes the bias of its offset
within that window. Patch merging concatenates the eight distinct 2^3
neighbours in (d, h, w) offset order (MONAI's ``PatchMergingV2``).

Compute dtype: parameters stay float32 and are cast to ``dtype`` at use
(:mod:`ich_tpu_torch.models.layers`); the logits are cast to float32
before the sigmoid. Under ``torch.profiler`` the encoder shows as
``swin_encoder`` and each block's attention core, from the partitioned
q, k, v to the output before the projection, as ``window_attention``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ich_tpu_torch.models.layers import Conv3d, ConvTranspose3d, Linear

Dims = Tuple[int, int, int]


def window_and_shift(res: Sequence[int], window: int, shift: int) -> Tuple[Dims, Dims]:
    """The window and shift per axis at resolution ``res``: where the
    resolution is at most ``window``, the window is the resolution and
    the shift 0."""
    return (tuple(r if r <= window else window for r in res),
            tuple(0 if r <= window else shift for r in res))


def window_partition(x: torch.Tensor, ws: Dims) -> torch.Tensor:
    """(B, D, H, W, C), every side a multiple of its window, to (B * nW, N,
    C) windows of N = prod(ws) tokens, windows in (d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws: Dims, dims: Dims) -> torch.Tensor:
    """The inverse of :func:`window_partition` onto (B, *dims, C)."""
    d, h, w = dims
    c = windows.shape[-1]
    x = windows.view(-1, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(-1, d, h, w, c)


@functools.lru_cache(maxsize=16)
def relative_position_index(ws: Dims, window: int, device: torch.device) -> torch.Tensor:
    """(N, N) index into the (2 window - 1)^3 bias table of each token
    pair of a ``ws`` window: ``(dz + w - 1)(2w - 1)^2 + (dy + w - 1)(2w - 1)
    + dx + w - 1``, d the offset of token i from token j."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(n) for n in ws], indexing="ij"))
    rel = coords.flatten(1)[:, :, None] - coords.flatten(1)[:, None, :] + (window - 1)
    side = 2 * window - 1
    return (rel[0] * side * side + rel[1] * side + rel[2]).to(device)


@functools.lru_cache(maxsize=16)
def shift_mask(dims: Dims, ws: Dims, ss: Dims, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """(nW, N, N) additive mask of a shifted block over the padded grid
    ``dims``: each voxel labelled by its region, per axis the slices [0,
    -ws), [-ws, -ss) and [-ss, end) (MONAI's ``compute_mask``); pairs of
    tokens in one window with different labels get -100, others 0."""
    img = torch.zeros(dims)
    regions = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, ss)]
    for label, (d, h, w) in enumerate(itertools.product(*regions)):
        img[d, h, w] = label
    lab = window_partition(img[None, ..., None], ws)[..., 0]
    mask = (lab[:, None, :] != lab[:, :, None]).to(torch.float32) * -100.0
    return mask.to(device=device, dtype=dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, its parameters in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, ws: Dims, mask: torch.Tensor | None) -> torch.Tensor:
        """(B * nW, N, C) windows; ``mask`` (nW, N, N) or None."""
        bw, n, c = x.shape
        qkv = self.qkv(x).view(bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        with torch.profiler.record_function("window_attention"):
            q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
            index = relative_position_index(ws, self.window, x.device)
            bias = self.relative_position_bias_table.to(x.dtype)[index.view(-1)]
            attn = q @ k.transpose(-2, -1) + bias.view(n, n, -1).permute(2, 0, 1)
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.view(bw // nw, nw, self.heads, n, n) + mask[None, :, None]).view(
                    bw, self.heads, n, n)
            out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> the same."""
        dims = tuple(x.shape[1:4])
        ws, ss = window_and_shift(dims, self.window, self.shift)
        y = self.norm1(x)
        pads = [-n % w for n, w in zip(dims, ws)]
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        padded = tuple(y.shape[1:4])
        mask = None
        if any(ss):
            y = torch.roll(y, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
            mask = shift_mask(padded, ws, ss, y.device, y.dtype)
        y = window_reverse(self.attn(window_partition(y, ws), ws, mask), ws, padded)
        if any(ss):
            y = torch.roll(y, shifts=ss, dims=(1, 2, 3))
        x = x + y[:, :dims[0], :dims[1], :dims[2]]
        return x + self.mlp(self.norm2(x))


def merge_neighbours(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C), odd sides padded by one, to (B, D/2, H/2, W/2, 8C):
    the eight distinct 2^3 neighbours concatenated in (d, h, w) offset
    order."""
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    return torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)],
                     dim=-1)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(merge_neighbours(x)))


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth))
        self.merge = PatchMerging(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.merge(x)


def _channels_first_normed(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) LayerNorm'd over C without affine, as (B, C, D, H,
    W)."""
    return F.layer_norm(x, x.shape[-1:]).permute(0, 4, 1, 2, 3).contiguous()


class SwinEncoder(nn.Module):
    def __init__(self, in_channels: int, feature_size: int, depths: Sequence[int],
                 num_heads: Sequence[int], window: int, patch_size: int, mlp_ratio: float):
        super().__init__()
        self.patch_embed = Conv3d(in_channels, feature_size, patch_size, stride=patch_size)
        self.stages = nn.ModuleList(
            Stage(feature_size * 2 ** i, d, h, window, mlp_ratio)
            for i, (d, h) in enumerate(zip(depths, num_heads)))

    def forward(self, x: torch.Tensor):
        """The hidden states ``h0`` .. ``h4``, channels first."""
        x = self.patch_embed(x).permute(0, 2, 3, 4, 1).contiguous()
        hidden = [_channels_first_normed(x)]
        for stage in self.stages:
            x = stage(x)
            hidden.append(_channels_first_normed(x))
        return hidden


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm without affine, eps 1e-5 (ATen's; a single voxel
    normalises to 0, where ``F.instance_norm`` refuses it)."""
    return torch.instance_norm(x, None, None, None, None, True, 0.0, 1e-5,
                               torch.backends.cudnn.enabled)


def _in_lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(_instance_norm(x), 0.01)


class ResBlock(nn.Module):
    """UNETR's residual block: 3^3 conv, InstanceNorm, LeakyReLU, 3^3 conv,
    InstanceNorm, plus the input (through a 1^3 conv and InstanceNorm where
    the width changes), then LeakyReLU. No conv bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 3, padding=1, bias=False)
        self.conv2 = Conv3d(cout, cout, 3, padding=1, bias=False)
        self.conv3 = Conv3d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _instance_norm(self.conv2(_in_lrelu(self.conv1(x))))
        res = x if self.conv3 is None else _instance_norm(self.conv3(x))
        return F.leaky_relu(y + res, 0.01)


class UpBlock(nn.Module):
    """A 2^3 stride-2 transposed conv (no bias), the skip concatenated
    after it, and a residual block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = ConvTranspose3d(cin, cout, 2, stride=2, bias=False)
        self.block = ResBlock(2 * cout, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block(torch.cat([self.up(x), skip], dim=1))


class SwinUNETR(nn.Module):
    """(B, in_channels, D, H, W) -> (B, out_channels, D, H, W) float32
    probabilities (a sigmoid), or logits with ``use_final_activation``
    False. Every side a multiple of 32. Parameters start at zero; load
    weights into them."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 2, mlp_ratio: float = 4.0,
                 use_final_activation: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feature_size
        self.dtype, self.use_final_activation = dtype, use_final_activation
        self.swin = SwinEncoder(in_channels, f, depths, num_heads, window_size, patch_size,
                                mlp_ratio)
        self.encoder1 = ResBlock(in_channels, f)
        self.encoder2 = ResBlock(f, f)
        self.encoder3 = ResBlock(2 * f, 2 * f)
        self.encoder4 = ResBlock(4 * f, 4 * f)
        self.encoder10 = ResBlock(16 * f, 16 * f)
        self.decoder5 = UpBlock(16 * f, 8 * f)
        self.decoder4 = UpBlock(8 * f, 4 * f)
        self.decoder3 = UpBlock(4 * f, 2 * f)
        self.decoder2 = UpBlock(2 * f, f)
        self.decoder1 = UpBlock(f, f)
        self.out = Conv3d(f, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        with torch.profiler.record_function("swin_encoder"):
            h0, h1, h2, h3, h4 = self.swin(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(h0)
        enc2 = self.encoder3(h1)
        enc3 = self.encoder4(h2)
        dec = self.decoder5(self.encoder10(h4), h3)
        dec = self.decoder4(dec, enc3)
        dec = self.decoder3(dec, enc2)
        dec = self.decoder2(dec, enc1)
        logits = self.out(self.decoder1(dec, enc0)).to(torch.float32)
        return torch.sigmoid(logits) if self.use_final_activation else logits
