"""Building blocks of the U-Net (counterpart of :mod:`ich_tpu.models.layers`).

Modules take channels-first tensors (NCHW / NCDHW), PyTorch's layout; the
JAX package's are channels-last. ``PConv``'s lane packing is a TPU trick
and is not ported: a conv here is ``nn.Conv2d`` / ``nn.Conv3d``.

Compute dtype: parameters stay float32 and the convs, transposed convs and
GroupNorms cast them to the input's dtype at use, as flax's
``promote_dtype`` does, so a bf16 input runs bf16 convs (float32
accumulation) while the ``state_dict`` stays float32. A ``ConvBlock``'s
GroupNorm and the ReLU after it are one call,
:func:`ich_tpu_torch.ops.group_norm.group_norm_relu` (torch's
``group_norm`` and ``relu`` on the CPU, fused kernels on the card):
statistics in float32, the normalisation in float32, one rounding to bf16.
The JAX package's ``FlatGroupNorm`` rounds its folded scale and shift to
bf16 first and normalises in bf16: one rounding away (held at 2e-2 on
probabilities by ``tests/test_torch_segment_volume_3d.py``).

Training follows flax, not torch's defaults: a network family's
constructor draws every conv, transposed-conv and dense kernel as flax's
``lecun_normal`` does, from the family's key
(:func:`ich_tpu_torch.models.init.init_like_flax`), and the layers here
start at zero until it does, drawing nothing from torch's generator;
BatchNorm's running variance takes the biased batch variance; dropout
draws flax's mask: XLA's Philox stream under the key that flax derives
from the step's dropout key, which the trainer sets
(:func:`set_dropout_keys`), and the module's
path, so that a resumed run replays the uninterrupted one and world N
draws world 1's masks.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ich_tpu_torch.ops.dropout import keyed_dropout
from ich_tpu_torch.ops.group_norm import group_norm_relu
from ich_tpu_torch.parallel.mesh import all_reduce_sum


def _zero_reset(m: nn.Module) -> None:
    """Zero weights until the family's ``init_like_flax`` draws them."""
    with torch.no_grad():
        m.weight.zero_()
        if m.bias is not None:
            m.bias.zero_()


def _params_as(m: nn.Module, x: torch.Tensor):
    """``m``'s weight and bias in ``x``'s dtype (no copy when they match)."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return m.weight.to(x.dtype), bias


class Conv2d(nn.Conv2d):
    def reset_parameters(self) -> None:
        _zero_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, *_params_as(self, x))


class Conv3d(nn.Conv3d):
    def reset_parameters(self) -> None:
        _zero_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, *_params_as(self, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    def reset_parameters(self) -> None:
        _zero_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, *_params_as(self, x), self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class ConvTranspose3d(nn.ConvTranspose3d):
    def reset_parameters(self) -> None:
        _zero_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(x, *_params_as(self, x), self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def reset_parameters(self) -> None:
        _zero_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *_params_as(self, x))


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, *_params_as(self, x), self.eps)


def _batch_norm_forward(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Eval: the running statistics. Train: the batch's biased statistics,
    and the running averages updated with momentum as flax does
    (``ra = 0.9 ra + 0.1 batch``), the variance's with the biased batch
    variance ``v``. torch's own update takes the unbiased ``k v``,
    ``k = n / (n - 1)``; rescaling its result per channel,
    ``ra = torch_ra / k + (1 - m)(1 - 1/k) ra_old``, gives flax's update
    without a second pass over the activations. With ``update_stats``
    False (a checkpointed block's recompute) the update goes to copies and
    the running averages stay as they are. With ``bn.mesh`` set
    (:func:`sync_batch_norm`), train mode takes the global batch's
    statistics (:func:`_sync_batch_norm`)."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    if bn.mesh is not None:
        return _sync_batch_norm(bn, x)
    if not bn.update_stats:
        return F.batch_norm(x, bn.running_mean.clone(), bn.running_var.clone(), bn.weight,
                            bn.bias, True, bn.momentum, bn.eps)
    k = x.numel() / x.shape[1]
    k = k / (k - 1.0)
    m = bn.momentum
    # batch_norm's backward keeps the variance buffer it was given: hand it
    # a copy, so that the buffer's in-place update below leaves it intact
    torch_ra = bn.running_var.clone()
    out = F.batch_norm(x, bn.running_mean, torch_ra, bn.weight, bn.bias, True, m, bn.eps)
    with torch.no_grad():
        bn.running_var.mul_((1.0 - m) * (1.0 - 1.0 / k)).add_(torch_ra, alpha=1.0 / k)
    return out


def _sync_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Train mode over ``bn.mesh``: the per-channel sum, sum of squares and
    count all-reduced with gradient (issued at any world size), the global
    biased statistics ``E[x^2] - E[x]^2`` (flax's one-pass variance) for the
    normalisation, and flax's running update ``ra = (1 - m) ra + m batch``
    with the global mean and biased variance."""
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    xf = x.to(torch.float32)
    local = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                       xf.new_full((1,), x.numel() / c)])
    stats = all_reduce_sum(local, bn.mesh)
    count = stats[2 * c]
    mean = stats[:c] / count
    var = torch.clamp(stats[c:2 * c] / count - mean * mean, min=0.0)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    shift = bn.bias - mean * scale
    shape = (1, c) + (1,) * (x.dim() - 2)
    if bn.update_stats:
        m = bn.momentum
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def sync_batch_norm(net: nn.Module, mesh) -> nn.Module:
    """Make every BatchNorm under ``net`` normalise with the statistics of
    the global batch over ``mesh`` in train mode (``None``: the local
    batch). The ``state_dict`` keys do not change. torch's
    ``SyncBatchNorm`` is not used: it refuses CPU tensors and keeps an
    unbiased running variance."""
    for m in net.modules():
        if isinstance(m, (BatchNorm2d, BatchNorm3d)):
            m.mesh = mesh
    return net


@contextlib.contextmanager
def stats_frozen(net: nn.Module):
    """Inside the block, the train-mode normalisations under ``net`` (every
    module with an ``update_stats`` flag: BatchNorm, spectral norm) compute
    as usual but store no statistics: BatchNorm's running-average update
    goes to copies. A checkpointed call's recompute and the SN-PatchGAN's D
    step run the forward a second time under it."""
    mods = [m for m in net.modules() if hasattr(m, "update_stats")]
    for m in mods:
        m.update_stats = False
    try:
        yield
    finally:
        for m in mods:
            del m.update_stats  # back to the class's True


class BatchNorm2d(nn.BatchNorm2d):
    update_stats = True
    mesh = None  # set by sync_batch_norm
    forward = _batch_norm_forward


class BatchNorm3d(nn.BatchNorm3d):
    update_stats = True
    mesh = None  # set by sync_batch_norm
    forward = _batch_norm_forward


class Dropout(nn.Module):
    """flax's ``nn.Dropout(p)`` in train mode (:func:`ich_tpu_torch.ops.
    dropout.keyed_dropout`): keep where XLA's Philox stream under flax's
    key of this Dropout says so, and divide by ``1 - p``.

    ``flax_path`` is the scope path of the JAX net's Dropout at this place
    and ``fold`` its SHA-1 word, set by the family's walk
    (``init_like_flax``); ``key`` is the step's dropout key (two threefry
    words) and ``shard`` this rank's index in the global batch, both set by
    :func:`set_dropout_keys`. A rank draws the
    stream from ``shard * x.numel()``: its rows of the global batch's mask.
    Without a key (a net run in train mode outside a trainer's step) each
    call draws its key from torch's generator, as ``nn.Dropout`` draws its
    mask."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.flax_path: Tuple[str, ...] | None = None
        self.fold = 0
        self.key: Tuple[int, int] | None = None
        self.shard = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        key = self.key
        if key is None:
            key = tuple(torch.randint(0, 1 << 32, (2,), dtype=torch.int64).tolist())
        with torch.profiler.record_function("dropout"):
            return keyed_dropout(x, (*key, self.fold), self.p, self.shard * x.numel())

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_keys(net: nn.Module, key: Optional[torch.Tensor], mesh=None) -> None:
    """Give every Dropout of ``net`` the step's dropout key ``key`` (a
    threefry key), from which it draws the masks of flax's ``net.apply(...,
    rngs={"dropout": dropout_key(key)})``: ``fold_in`` of that ``rbg`` key
    with its ``fold`` word (:func:`ich_tpu_torch.ops.dropout.
    flax_dropout_key`, in the kernel on the card). Under ``mesh`` this rank
    draws its rows of the global batch's masks. ``key`` None clears the
    keys."""
    words = None if key is None else tuple(
        int(w) & 0xFFFFFFFF for w in torch.as_tensor(key).reshape(2).tolist())
    shard = 0 if mesh is None else mesh.rank
    for m in net.modules():  # not named_modules: this runs every step
        if not isinstance(m, Dropout):
            continue
        if words is not None and m.flax_path is None:
            name = next(n for n, x in net.named_modules() if x is m)
            raise ValueError(f"set_dropout_keys: Dropout {name!r} has no flax path "
                             "(its family's walk does not reach it)")
        m.key, m.shard = words, shard


_CONV = {2: Conv2d, 3: Conv3d}
_CONVT = {2: ConvTranspose2d, 3: ConvTranspose3d}
_BN = {2: BatchNorm2d, 3: BatchNorm3d}


def normalize_p_dropout(p_dropout: Union[float, Sequence[float]], depth: int) -> Tuple[float, ...]:
    """Float -> repeated per level; list -> validated."""
    if isinstance(p_dropout, (float, int)):
        return (float(p_dropout),) * depth
    p = tuple(float(x) for x in p_dropout)
    if len(p) != depth:
        raise ValueError(f"p_dropout list length {len(p)} != depth {depth}")
    return p


def make_norm(kind: str, channels: int, ndim: int) -> nn.Module:
    """The JAX package's ``Norm``: BatchNorm (eps 1e-5; flax momentum 0.9 is
    torch momentum 0.1), GroupNorm as ``FlatGroupNorm`` (eps 1e-6,
    ``max(1, C // 16)`` groups), or ``"none"``, the identity."""
    if kind == "batch":
        return _BN[ndim](channels, eps=1e-5, momentum=0.1)
    if kind == "group":
        return GroupNorm(max(1, channels // 16), channels, eps=1e-6)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


def norm_relu(norm: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """``relu(norm(y))``. A GroupNorm and the ReLU are one call,
    :func:`ich_tpu_torch.ops.group_norm.group_norm_relu` (its kernels on the
    card), inside a ``group_norm`` profiler range; any other norm runs
    ``F.relu(norm(y))``."""
    if isinstance(norm, GroupNorm):
        with torch.profiler.record_function("group_norm"):
            # contiguous, as torch's group_norm makes its input
            return group_norm_relu(y.contiguous(), norm.num_groups, norm.weight, norm.bias,
                                   norm.eps)
    return F.relu(norm(y))


class ConvBlock(nn.Module):
    """Double [3x3 conv -> norm -> ReLU] with SAME padding and stride 1, and
    dropout at the end (off in eval). Submodule names ``conv1``, ``bn1``,
    ``conv2``, ``bn2`` follow the reference's torch ``ConvBlock``; a
    GroupNorm and its ReLU run fused (:func:`norm_relu`).

    ``gated``: each conv is a gated conv (Yu 2019; the reference's
    ``GatedUNet``, ``GatedUNet.py:121-320``), as the JAX package's: one
    conv emits ``2 ch`` channels, and the first half (the features) times
    the sigmoid of the second (the gate) goes on.

    ``remat``: while gradients are recorded, the block runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept and
    its activations are recomputed in the backward pass, as the JAX
    package's ``nn.remat``. The recompute draws the forward's dropout masks
    again (they are a function of the key; a keyless Dropout's key comes
    from torch's generator, whose state the checkpoint restores) and leaves
    BatchNorm's running averages alone (they were updated once, in the
    forward)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 ndim: int = 2, p_dropout: float = 0.0, norm: str = "batch",
                 remat: bool = False, gated: bool = False):
        super().__init__()
        mid = mid_channels or out_channels
        g = 2 if gated else 1
        self.conv1 = _CONV[ndim](in_channels, g * mid, 3, padding=1)
        self.bn1 = make_norm(norm, mid, ndim)
        self.conv2 = _CONV[ndim](mid, g * out_channels, 3, padding=1)
        self.bn2 = make_norm(norm, out_channels, ndim)
        self.dropout = Dropout(p_dropout) if p_dropout > 0.0 else nn.Identity()
        self.remat = remat
        self.gated = gated

    def _conv(self, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        y = conv(x)
        if not self.gated:
            return y
        feat, gate = torch.chunk(y, 2, dim=1)
        return feat * torch.sigmoid(gate)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        x = norm_relu(self.bn1, self._conv(self.conv1, x))
        x = norm_relu(self.bn2, self._conv(self.conv2, x))
        return self.dropout(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._body, x, use_reentrant=False,
                              context_fn=self._remat_contexts)
        return self._body(x)

    def _remat_contexts(self):
        """The (forward, recompute) contexts of one checkpointed call."""
        return contextlib.nullcontext(), stats_frozen(self)


def max_pool(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """2x (or 2x2x2) max pooling, stride 2."""
    return F.max_pool2d(x, 2) if ndim == 2 else F.max_pool3d(x, 2)


def upsample_linear(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """x2 bi/trilinear upsampling with the corner-aligned grid
    (``align_corners=True``)."""
    mode = "bilinear" if ndim == 2 else "trilinear"
    return F.interpolate(x, scale_factor=2, mode=mode, align_corners=True)


def up_conv(in_channels: int, out_channels: int, ndim: int) -> nn.Module:
    """The JAX package's ``UpConv``: a transposed conv, kernel 2, stride 2."""
    return _CONVT[ndim](in_channels, out_channels, kernel_size=2, stride=2)


class MLPHead(nn.Module):
    """The JAX package's ``MLPHead``: Linear layers with a ReLU between them
    (none after the last), ``features`` the size of each layer's output.
    ``fc_layers.{i}`` are the reference torch head's keys."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        sizes = [in_features] + list(features)
        self.fc_layers = nn.ModuleList(Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, fc in enumerate(self.fc_layers):
            x = fc(x) if i == len(self.fc_layers) - 1 else F.relu(fc(x))
        return x


class ConvHead(nn.Module):
    """The JAX package's ``ConvHead``: 1x1 convs with a ReLU between them
    (none after the last). ``conv_layers.{i}`` are the reference torch
    head's keys."""

    def __init__(self, in_channels: int, features: Sequence[int], ndim: int = 2):
        super().__init__()
        sizes = [in_channels] + list(features)
        self.conv_layers = nn.ModuleList(_CONV[ndim](a, b, 1) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.conv_layers):
            x = conv(x) if i == len(self.conv_layers) - 1 else F.relu(conv(x))
        return x
