"""SN-PatchGAN inpainting networks (counterpart of
:mod:`ich_tpu.models.inpainting`): gated convolutions, the two-stage
coarse -> refine generators with the dilation pyramid 2/4/8/16
(``GatedGenerator`` with contextual attention, ``SAGatedGenerator`` with
SAGAN self-attention) and the spectral-norm patch discriminator.

The networks take and return channels-last tensors, (B, H, W, C), as the
JAX package's do; inside, the convs run channels-first on cuDNN.

What follows the JAX package and not torch's defaults:

- a gated conv is ONE conv with 2F outputs, the feature half first and the
  gate half second; BatchNorm (flax's running update) on the feature half
  only; ``act(feat) * sigmoid(gate)``;
- reflect padding pads as ``numpy.pad(mode="reflect")`` for any width: a pad
  at least the side reflects again (the dilation-16 layer pads 16 on an
  8-wide map at 32^2); torch's ``F.pad`` would raise there;
- spectral normalisation is flax's ``nn.SpectralNorm``: the conv kernel
  viewed as (kh * kw * Cin, Cout), ``u`` (1, Cout) and ``sigma`` as
  buffers, one power step from the stored ``u`` on EVERY call (eval mode
  too), ``x * rsqrt(sum(x^2) + 1e-12)`` normalisation, ``u`` and ``v``
  without gradient, sigma = v W u^T with its gradient through W, W / sigma
  where sigma != 0; only a call in train mode stores ``u`` and ``sigma``.
  ``torch.nn.utils.spectral_norm`` differs on all of these;
- contextual attention's conventions: torch-style SAME padding (``pad //
  2`` first), patch features (C, kh, kw) moved to (kh, kw, C), the mask
  downsampled at ``floor(dst * in / out)``, eps inside the sum of the norm,
  the fuse's transposes, and the overlap-add canvas cropped to the input.

``remat=True`` checkpoints every gated conv (and the attention) as the JAX
package's ``nn.remat`` does; the recompute leaves the BatchNorm statistics
and the spectral-norm ``u`` alone and replays the forward's ``u``.
State-dict keys follow the reference's modules where the layout allows
(``coarse.{i}``, ``refine_attention.0``, ``layer_list.{i}``); the fused
gate conv is one ``conv``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ich_tpu_torch.interop.from_jax import (
    walk_gated_generator,
    walk_patch_discriminator,
    walk_sa_gated_generator,
)
from ich_tpu_torch.models.init import init_like_flax
from ich_tpu_torch.models.layers import BatchNorm2d, Conv2d, stats_frozen
from ich_tpu_torch.utils.config import NETWORKS

_ACT = {
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.2),
    "prelu": lambda x: F.leaky_relu(x, 0.25),
    "selu": F.selu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": lambda x: x,
}


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int) -> np.ndarray:
    return np.pad(np.arange(n), pad, mode="reflect")


def pad_reflect(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """(B, C, H, W) padded by ``pad`` on each side of H and W: ``reflect``
    as ``numpy.pad`` for any ``pad`` (an index gather once the pad reaches
    the side), or ``constant`` zeros."""
    if pad == 0:
        return x
    if mode == "constant":
        return F.pad(x, (pad, pad, pad, pad))
    h, w = x.shape[-2:]
    if pad < min(h, w):
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    iy = torch.as_tensor(_reflect_index(h, pad), device=x.device)
    ix = torch.as_tensor(_reflect_index(w, pad), device=x.device)
    return x.index_select(2, iy).index_select(3, ix)


def _norm(channels: int) -> BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9)`` (eps 1e-5): torch momentum 0.1."""
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class GatedConv2d(nn.Module):
    """Gated convolution (reference ``GatedConv2d:88-158``): one conv with
    ``2 * features`` outputs, feature half then gate half."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, padding: int = 1, padding_mode: str = "reflect",
                 activation: str = "relu", batch_norm: bool = True):
        super().__init__()
        self.features = features
        self.padding, self.padding_mode, self.activation = padding, padding_mode, activation
        self.conv = Conv2d(in_channels, 2 * features, kernel_size, stride=stride,
                           dilation=dilation)
        self.norm = _norm(features) if batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(pad_reflect(x, self.padding, self.padding_mode))
        feat, gate = y[:, :self.features], y[:, self.features:]
        if self.norm is not None:
            feat = self.norm(feat)
        return _ACT[self.activation](feat) * torch.sigmoid(gate)


class UpsampleGatedConv2d(nn.Module):
    """Nearest x2 upsampling, then a gated conv (reference
    ``UpsampleGatedConv2d:159``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, padding: int = 1, padding_mode: str = "reflect",
                 activation: str = "relu", batch_norm: bool = True, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.gated_conv = GatedConv2d(in_channels, features, kernel_size, stride, dilation,
                                      padding, padding_mode, activation, batch_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=self.scale_factor, mode="nearest")
        return self.gated_conv(x)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class SNConv2d(nn.Module):
    """Conv with flax's spectral normalisation (``u``, ``sigma`` buffers),
    BatchNorm and an activation (reference ``Conv2dLayer:14`` +
    ``SpectralNorm:209``). ``update_stats`` False (a checkpointed call's
    recompute) stores nothing; ``replay_u`` set replaces the stored ``u``."""

    update_stats = True

    def __init__(self, in_channels: int, features: int, kernel_size: int = 5, stride: int = 2,
                 padding: int = 2, activation: str = "lrelu", batch_norm: bool = True,
                 sn: bool = True, padding_mode: str = "constant"):
        super().__init__()
        self.padding, self.activation, self.sn = padding, activation, sn
        self.padding_mode = "reflect" if padding_mode == "reflect" else "constant"
        self.stride = stride
        self.conv = Conv2d(in_channels, features, kernel_size, stride=stride)
        if sn:
            self.register_buffer("u", torch.zeros(1, features))  # drawn by the family
            self.register_buffer("sigma", torch.ones(()))
        self.replay_u: Optional[torch.Tensor] = None
        self.norm = _norm(features) if batch_norm else None

    def sn_weight(self) -> torch.Tensor:
        """The kernel divided by its spectral norm after one power step;
        stores ``u`` and ``sigma`` in train mode."""
        w = self.conv.weight
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # flax's (kh*kw*Cin, Cout)
        with torch.no_grad():
            u0 = self.u if self.replay_u is None else self.replay_u
            v0 = _l2_normalize(u0 @ mat.t())
            u0 = _l2_normalize(v0 @ mat)
        sigma = (v0 @ mat @ u0.t())[0, 0]
        if self.training and self.update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def normalize_kernel_(self) -> None:
        """Divide the kernel by the spectral norm one power step from ``u``
        estimates, storing nothing else: flax's ``SpectralNorm`` leaves its
        layer's kernel so after ``init``."""
        training = self.training
        with torch.no_grad():
            self.train(False)
            self.conv.weight.copy_(self.sn_weight())
        self.train(training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_reflect(x, self.padding, self.padding_mode)
        if self.sn:
            x = F.conv2d(x, self.sn_weight(), self.conv.bias, self.stride)
        else:
            x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return _ACT[self.activation](x)


class SelfAttention(nn.Module):
    """SAGAN self-attention with a learned residual gate (reference
    ``SelfAttention:429-468``): 1x1 convs f, g (C/8) and h (C), softmax over
    the keys without a 1/sqrt(d) scale, ``gamma`` initialised to 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_f = Conv2d(channels, channels // 8, 1)
        self.conv_g = Conv2d(channels, channels // 8, 1)
        self.conv_h = Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        f = self.conv_f(x).flatten(2).transpose(1, 2)  # (B, HW, C/8): queries
        g = self.conv_g(x).flatten(2)  # (B, C/8, HW): keys
        v = self.conv_h(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        attn = torch.softmax(torch.bmm(f, g), dim=-1)
        out = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * out + x


def extract_patches(x: torch.Tensor, k: int, stride: int, dilation: int = 1) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, k, k, C) patches with torch-style SAME padding
    (``pad // 2`` before), L in row-major order of the patch grid."""
    b, h, w, c = x.shape
    out_h, out_w = -(-h // stride), -(-w // stride)
    eff_k = (k - 1) * dilation + 1
    pad_h = max(0, (out_h - 1) * stride + eff_k - h)
    pad_w = max(0, (out_w - 1) * stride + eff_k - w)
    xc = F.pad(x.permute(0, 3, 1, 2), (pad_w // 2, pad_w - pad_w // 2,
                                       pad_h // 2, pad_h - pad_h // 2))
    cols = F.unfold(xc, k, dilation=dilation, stride=stride)  # (B, C*k*k, L), (C, kh, kw)
    return cols.reshape(b, c, k, k, -1).permute(0, 4, 2, 3, 1)


class ContextualAttention(nn.Module):
    """Yu-2018 contextual attention, batched (reference ``:296-427``): the
    similarity of every foreground pixel's patch with every normalised
    background patch, optionally fused along both grids by identity
    kernels, weighted by the mask's patch means, softmax over the patches
    and the raw background patches overlap-added back. fg, bg (B, H, W, C);
    mask (B, H, W[, 1]). Holds no parameters."""

    def __init__(self, kernel_size: int = 3, patch_stride: int = 1, compression_rate: int = 1,
                 softmax_scale: float = 10.0, fuse: bool = False, fuse_kernel: int = 3,
                 eps: float = 1e-9):
        super().__init__()
        self.kernel_size, self.patch_stride = kernel_size, patch_stride
        self.compression_rate, self.softmax_scale = compression_rate, softmax_scale
        self.fuse, self.fuse_kernel, self.eps = fuse, fuse_kernel, eps

    def _fuse_conv(self, s: torch.Tensor) -> torch.Tensor:
        """Identity-kernel conv of a (B, H, W, 1) map, SAME padding."""
        fk = self.fuse_kernel
        lo, hi = (fk - 1) // 2, fk - 1 - (fk - 1) // 2
        eye = torch.eye(fk, dtype=s.dtype, device=s.device).reshape(1, 1, fk, fk)
        y = F.conv2d(F.pad(s.permute(0, 3, 1, 2), (lo, hi, lo, hi)), eye)
        return y.permute(0, 2, 3, 1)

    def forward(self, fg: torch.Tensor, bg: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, in_h, in_w, c = fg.shape
        cr, ks, st = self.compression_rate, self.kernel_size, self.patch_stride
        raw_k = 2 * cr
        # raw-resolution reconstruction patches: dilation = compression rate
        w_recon = extract_patches(bg, raw_k, cr * st, dilation=cr)  # (B, L, rk, rk, C)
        if cr > 1:
            fg, bg = fg[:, ::cr, ::cr, :], bg[:, ::cr, ::cr, :]
        hh, ww = fg.shape[1:3]
        w_sim = extract_patches(bg, ks, st)  # (B, L, k, k, C)
        n_l = w_sim.shape[1]

        if mask is None:
            m = torch.ones((b, 1, n_l), dtype=fg.dtype, device=fg.device)
        else:
            if mask.dim() == 3:
                mask = mask[..., None]
            # torch's nearest: src = floor(dst * in / out)
            sy = (torch.arange(hh, device=mask.device) * mask.shape[1]) // hh
            sx = (torch.arange(ww, device=mask.device) * mask.shape[2]) // ww
            mk = mask[:, sy][:, :, sx]
            m = torch.mean(extract_patches(mk, ks, st), dim=(2, 3, 4))[:, None, :]  # (B, 1, L)

        w_flat = w_sim.reshape(b, n_l, -1)
        # eps inside the sum (reference :393)
        w_norm = w_flat / torch.sqrt(torch.sum(w_flat ** 2 + self.eps, dim=-1, keepdim=True))
        fg_patch = extract_patches(fg, ks, 1).reshape(b, hh * ww, -1)
        sim = torch.bmm(fg_patch, w_norm.transpose(1, 2))  # (B, P, L)

        if self.fuse:
            s = sim.transpose(1, 2).reshape(b, n_l, hh * ww, 1)
            s = self._fuse_conv(s)
            n_bh, n_bw = hh // st, ww // st
            s = s.reshape(b, n_bh, n_bw, hh, ww).permute(0, 2, 1, 4, 3)
            s = self._fuse_conv(s.reshape(b, n_l, hh * ww, 1))
            s = s.reshape(b, n_bw, n_bh, ww, hh).permute(0, 2, 1, 4, 3)
            sim = s.reshape(b, n_l, hh * ww).transpose(1, 2)

        sim = sim * m
        sim = torch.softmax(sim * self.softmax_scale, dim=-1) * m

        # attention-weighted raw patches, overlap-added on the raw grid
        recon = torch.bmm(sim, w_recon.reshape(b, n_l, -1)).reshape(b, hh, ww, raw_k, raw_k, c)
        canvas = torch.zeros((b, hh * cr + raw_k, ww * cr + raw_k, c), dtype=fg.dtype,
                             device=fg.device)
        for di in range(raw_k):
            for dj in range(raw_k):
                canvas[:, di:di + hh * cr:cr, dj:dj + ww * cr:cr, :] += recon[:, :, :, di, dj, :]
        return (canvas / raw_k ** 2)[:, :in_h, :in_w, :]


def _coarse_layers(lat: int, out_ch: int, act: str, norm: bool) -> tuple:
    """The shared 17-layer coarse encoder-decoder (reference ``:502-526``):
    stride-2 x2 down, the dilation pyramid 2/4/8/16, x2 up x2. Each spec:
    (features, kernel, stride, dilation, padding, act, bn, up)."""
    def gc(f, k=3, s=1, d=1, p=1, a=act, bn=norm):
        return (f, k, s, d, p, a, bn, False)

    def up(f):
        return (f, 3, 1, 1, 1, act, norm, True)

    return (
        gc(lat, k=5, p=2, bn=False),
        gc(2 * lat, s=2), gc(2 * lat),
        gc(4 * lat, s=2), gc(4 * lat), gc(4 * lat),
        gc(4 * lat, d=2, p=2), gc(4 * lat, d=4, p=4),
        gc(4 * lat, d=8, p=8), gc(4 * lat, d=16, p=16),
        gc(4 * lat), gc(4 * lat),
        up(2 * lat), gc(2 * lat),
        up(lat), gc(lat // 2),
        gc(out_ch, a="sigmoid", bn=False),
    )


def _remat_contexts(module: nn.Module):
    """The (forward, recompute) contexts of one checkpointed call of
    ``module``: the recompute sends BatchNorm's update to copies, stores no
    spectral-norm statistics and replays the ``u`` the forward started
    from."""
    sns = [m for m in module.modules() if isinstance(m, SNConv2d) and m.sn]
    saved = {}

    @contextlib.contextmanager
    def forward():
        for m in sns:
            saved[m] = m.u.clone()
        yield

    @contextlib.contextmanager
    def recompute():
        for m in sns:
            m.replay_u = saved[m]
        try:
            with stats_frozen(module):
                yield
        finally:
            for m in sns:
                m.replay_u = None

    return forward(), recompute()


def _call(module: nn.Module, remat: bool, *args):
    """``module(*args)``, under a non-reentrant checkpoint when ``remat``
    and gradients are recorded."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False,
                          context_fn=functools.partial(_remat_contexts, module))
    return module(*args)


class _GatedStack(nn.Sequential):
    """Gated convs built from :func:`_coarse_layers` specs; keys ``{i}``."""

    def __init__(self, in_channels: int, specs: Sequence[tuple], remat: bool = False):
        layers, c = [], in_channels
        for f, k, s, d, p, a, bn, up in specs:
            cls = UpsampleGatedConv2d if up else GatedConv2d
            layers.append(cls(c, f, k, stride=s, dilation=d, padding=p, activation=a,
                              batch_norm=bn))
            c = f
        super().__init__(*layers)
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = _call(layer, self.remat, x)
        return x


def _nchw(img: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) image and (B, H, W[, 1]) mask -> channels-first."""
    if mask.dim() == 3:
        mask = mask[..., None]
    return img.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _ContextBranch(nn.Module):
    """The contextual-attention branch of the refinement (reference
    ``refine_attention_enc``): 6 gated convs, the attention, 2 gated
    convs."""

    def __init__(self, in_channels: int, lat: int, act: str, norm: bool,
                 attention_kwargs: Optional[dict], remat: bool):
        super().__init__()
        self.remat = remat
        self.cnn1 = _GatedStack(in_channels, _coarse_layers(lat, 1, act, norm)[:6], remat)
        self.attention = ContextualAttention(**(attention_kwargs or {}))
        post = tuple((4 * lat, 3, 1, 1, 1, act, norm, False) for _ in range(2))
        self.cnn2 = _GatedStack(4 * lat, post, remat)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xc = _nhwc(self.cnn1(x))
        xc = _call(self.attention, self.remat, xc, xc, mask)
        return self.cnn2(xc.permute(0, 3, 1, 2))


class GatedGenerator(nn.Module):
    """Two-stage gated inpainting generator with an optional contextual
    attention branch (reference ``GatedGenerator:469-599``). ``forward(img
    (B, H, W, C), mask (B, H, W[, 1]))``, 1 = region to inpaint; returns
    ``(fine, coarse)`` (B, H, W, out_channels), or ``fine`` alone without
    ``return_coarse``. The weights are flax's ``init`` of the JAX
    ``GatedGenerator`` from ``key``."""

    _flax_walk = staticmethod(walk_gated_generator)

    def __init__(self, out_channels: int = 1, lat_channels: int = 32, activation: str = "relu",
                 norm: bool = True, context_attention: bool = True, return_coarse: bool = True,
                 context_attention_kwargs: Optional[dict] = None, remat: bool = False,
                 in_channels: int = 2, key: Optional[torch.Tensor] = None):
        super().__init__()
        lat, act = lat_channels, activation
        self.return_coarse = return_coarse
        specs = _coarse_layers(lat, out_channels, act, norm)
        self.coarse = _GatedStack(in_channels, specs, remat)
        self.refine_enc = _GatedStack(out_channels + 1, specs[:10], remat)
        self.refine_attention_enc = (
            _ContextBranch(out_channels + 1, lat, act, norm, context_attention_kwargs, remat)
            if context_attention else None)
        self.refine_dec = _GatedStack(4 * lat * (2 if context_attention else 1), specs[10:],
                                      remat)
        if type(self) is GatedGenerator:  # a subclass draws once its modules are built
            init_like_flax(self, key)

    def _middle(self, feat: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.refine_attention_enc is None:
            return feat
        return torch.cat([feat, self.refine_attention_enc(x2, _nhwc(mask))], dim=1)

    def forward(self, img: torch.Tensor, mask: torch.Tensor):
        img, mask = _nchw(img, mask)
        masked = img * (1.0 - mask)
        coarse = self.coarse(torch.cat([masked, mask], dim=1))
        x2 = torch.cat([coarse * mask + masked, mask], dim=1)
        feat = self._middle(self.refine_enc(x2), x2, mask)
        fine = _nhwc(self.refine_dec(feat))
        return (fine, _nhwc(coarse)) if self.return_coarse else fine


class SAGatedGenerator(GatedGenerator):
    """Self-attention variant (reference ``SAGatedGenerator:697-824``):
    SAGAN attention and a ReLU between ``refine_enc`` (the 10 layers ending
    at the dilation-16 conv) and ``refine_dec``, instead of the contextual
    branch."""

    _flax_walk = staticmethod(walk_sa_gated_generator)

    def __init__(self, out_channels: int = 1, lat_channels: int = 32, activation: str = "relu",
                 norm: bool = True, return_coarse: bool = True, remat: bool = False,
                 in_channels: int = 2, key: Optional[torch.Tensor] = None):
        super().__init__(out_channels, lat_channels, activation, norm, context_attention=False,
                         return_coarse=return_coarse, remat=remat, in_channels=in_channels)
        self.remat = remat
        self.refine_attention = nn.Sequential(SelfAttention(4 * lat_channels), nn.ReLU())
        init_like_flax(self, key)

    def _middle(self, feat: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.refine_attention[1](_call(self.refine_attention[0], self.remat, feat))


class PatchDiscriminator(nn.Module):
    """Spectral-norm conv stack on cat(img, mask) (reference
    ``PatchDiscriminator:601-695``): layer 0 at stride 1, BatchNorm on every
    layer (the last included), no activation on the last, and
    self-attention followed by a ReLU after layer n-2 (``layer_list`` keys
    as the reference's: the last conv at index n + 1). ``forward(img (B, H,
    W, C), mask (B, H, W[, 1]))`` -> (B, h, w, out_channels[-1]). The
    weights, ``u`` and ``sigma`` are flax's ``init`` of the JAX
    ``PatchDiscriminator`` from ``key``."""

    _flax_walk = staticmethod(walk_patch_discriminator)

    def __init__(self, out_channels: Sequence[int] = (64, 128, 256, 256, 256, 256),
                 kernel_size: int = 5, stride: int = 2, activation: str = "lrelu",
                 norm: bool = True, sn: bool = True, self_attention: bool = True,
                 remat: bool = False, in_channels: int = 2, key: Optional[torch.Tensor] = None):
        super().__init__()
        self.remat = remat
        layers, c, n = [], in_channels, len(out_channels)
        for i, f in enumerate(out_channels):
            layers.append(SNConv2d(c, f, kernel_size, stride=1 if i == 0 else stride,
                                   padding=(kernel_size - 1) // 2,
                                   activation="none" if i == n - 1 else activation,
                                   batch_norm=norm, sn=sn))
            if self_attention and i == n - 2:
                layers += [SelfAttention(f), nn.ReLU()]
            c = f
        self.layer_list = nn.ModuleList(layers)
        init_like_flax(self, key)

    def forward(self, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        img, mask = _nchw(img, mask)
        x = torch.cat([img, mask], dim=1)
        for layer in self.layer_list:
            x = _call(layer, self.remat and isinstance(layer, SNConv2d), x)
        return _nhwc(x)


def _pick(kw: dict, names: Tuple[str, ...]) -> dict:
    return {k: v for k, v in kw.items() if k in names}


NETWORKS.add(
    "GatedGenerator",
    lambda in_channels=2, out_channels=1, lat_channels=32, device=None,
    context_attention_kwargs=None, key=None, **kw: GatedGenerator(key=key,
        out_channels=out_channels, lat_channels=lat_channels, in_channels=in_channels,
        context_attention_kwargs={
            k: v for k, v in (context_attention_kwargs or {}).items() if k != "device"
        } or None,
        **_pick(kw, ("activation", "norm", "context_attention", "return_coarse", "remat"))),
)
NETWORKS.add(
    "SAGatedGenerator",
    lambda in_channels=2, out_channels=1, lat_channels=32, device=None, key=None,
    **kw: SAGatedGenerator(key=key,
        out_channels=out_channels, lat_channels=lat_channels, in_channels=in_channels,
        **_pick(kw, ("activation", "norm", "return_coarse", "remat"))),
)
NETWORKS.add(
    "PatchDiscriminator",
    lambda in_channels=2, device=None, key=None, **kw: PatchDiscriminator(
        in_channels=in_channels, key=key,
        **_pick(kw, ("out_channels", "kernel_size", "stride", "activation", "norm", "sn",
                     "self_attention", "remat"))),
)
