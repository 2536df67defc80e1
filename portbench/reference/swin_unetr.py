"""The plain Swin UNETR: the forward pass of Hatamizadeh et al.,
arXiv:2201.01266, as MONAI's ``SwinUNETR`` computes it, written as torch
functions over a ``state_dict``-keyed dict of tensors, in float32, one
patch at a time (a 128^3 patch's first stage holds 1,000 windows of 343
tokens: 1.4 GB of attention scores a patch).

Encoder: a 2^3 stride-2 conv with bias embeds the patch (no norm); four
stages of ``depths`` Swin blocks at widths ``feature_size * 2^i`` with
``num_heads`` heads, each stage followed by patch merging (the eight 2^3
neighbours concatenated, LayerNorm, a linear to twice the width without
bias). A block: ``y = LN1(x)``, zero-padded at the far end of each axis
to a multiple of the window, rolled by ``-shift`` in every second block,
cut into windows; per window ``softmax(q k^T / sqrt(d) + B + M) v`` with
``q, k, v`` from one linear with bias and a linear projection after it;
the windows put back, rolled back, the padding cropped; ``x = x + y``,
then ``x = x + fc2(GELU(fc1(LN2(x))))`` with the exact GELU. ``B`` is the
learned table's entry for each pair's offset within its window; ``M``,
in shifted blocks only, is -100 between tokens of one window that lie in
different regions of the rolled grid. Where a stage's resolution is at
most the window along an axis, the window is that resolution and the
shift 0. The embedding and each stage's output, LayerNorm'd without
affine, are the hidden states ``h0`` .. ``h4``.

Decoder: residual blocks (3^3 conv without bias, InstanceNorm without
affine, LeakyReLU 0.01, 3^3 conv, InstanceNorm, plus the input, through a
1^3 conv and InstanceNorm where the width changes, then LeakyReLU) on the
input and on ``h0``, ``h1``, ``h2`` and ``h4``; five up blocks (a 2^3
stride-2 transposed conv without bias, the skip concatenated after it, a
residual block); a 1^3 conv with bias to the logits, and a sigmoid.

Departures from MONAI: patch merging takes the eight distinct neighbours
in (d, h, w) offset order, as MONAI's ``PatchMergingV2`` (its default
``PatchMerging`` takes two neighbours twice and two not at all; the cost
is the same); where a window is clamped, each pair takes the bias of its
offset within the clamped window (MONAI takes the first rows of the full
window's index, a difference only below a 7-voxel stage resolution, which
a 128^3 patch does not reach); no dropout or drop path (0 at inference).

``quant``, where given, rounds every conv's and linear's input, weight and
output, q, k, v, the attention's probabilities and every norm's output:
the whole net held in the control's lower precision
(:mod:`portbench.reference.fp8`). ``train`` changes nothing: the net has
no layer that trains differently.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _plain(t: Tensor) -> Tensor:
    return t


def stage_windows(cfg: dict, spatial) -> list:
    """Per stage, (resolution, window, shift) per axis for a patch of
    ``spatial``."""
    w = cfg["window_size"]
    out = []
    for i in range(len(cfg["depths"])):
        res = [s // cfg["patch_size"] // 2 ** i for s in spatial]
        out.append((res, [r if r <= w else w for r in res], [0 if r <= w else w // 2 for r in res]))
    return out


@functools.lru_cache(maxsize=None)
def _bias_index(ws: tuple, window: int) -> Tensor:
    """(N, N) entry of the (2 window - 1)^3 table for each pair of a ``ws``
    window's tokens, taken in (z, y, x) order."""
    pos = list(itertools.product(*[range(n) for n in ws]))
    side = 2 * window - 1
    return torch.tensor([[(a[0] - b[0] + window - 1) * side * side
                          + (a[1] - b[1] + window - 1) * side + (a[2] - b[2] + window - 1)
                          for b in pos] for a in pos])


def _windows(x: Tensor, ws) -> Tensor:
    """(1, D, H, W, C) to (nW, N, C), windows and tokens in (z, y, x)
    order."""
    _, d, h, w, c = x.shape
    out = [x[0, z:z + ws[0], y:y + ws[1], v:v + ws[2]].reshape(-1, c)
           for z in range(0, d, ws[0]) for y in range(0, h, ws[1]) for v in range(0, w, ws[2])]
    return torch.stack(out)


def _unwindows(win: Tensor, ws, dims) -> Tensor:
    d, h, w = dims
    out = win.new_empty((1, d, h, w, win.shape[-1]))
    i = 0
    for z in range(0, d, ws[0]):
        for y in range(0, h, ws[1]):
            for v in range(0, w, ws[2]):
                out[0, z:z + ws[0], y:y + ws[1], v:v + ws[2]] = win[i].view(*ws, -1)
                i += 1
    return out


@functools.lru_cache(maxsize=None)
def _region_mask(dims: tuple, ws: tuple, ss: tuple) -> Tensor:
    """(nW, N, N): -100 between tokens of one window whose voxels of the
    rolled, padded grid ``dims`` lie in different regions, else 0. Per axis
    of n voxels the regions are [0, n - ws), [n - ws, n - ss) and [n - ss,
    n); where the shift is 0 the last is the whole axis (MONAI's
    ``slice(-0, None)``)."""
    def region(c, n, w, s):
        return 2 if s == 0 else (0 if c < n - w else 1 if c < n - s else 2)

    axes = [torch.tensor([region(c, n, w, s) for c in range(n)]) for n, w, s in zip(dims, ws, ss)]
    label = axes[0][:, None, None] * 9 + axes[1][None, :, None] * 3 + axes[2][None, None, :]
    lab = _windows(label[None, ..., None].float(), ws)[..., 0]
    return torch.where(lab[:, :, None] == lab[:, None, :], 0.0, -100.0)


def forward(p: Dict[str, Tensor], x: Tensor, cfg: dict, *, train: bool = False,
            quant: Optional[Callable[[Tensor], Tensor]] = None,
            logits: bool = False) -> Tensor:
    """(B, in_channels, D, H, W) -> (B, out_channels, D, H, W) probabilities
    (or logits), one patch at a time."""
    q = quant or _plain
    out = torch.cat([_patch(p, x[i:i + 1], cfg, q) for i in range(x.shape[0])])
    return out if logits else torch.sigmoid(out)


def _patch(p: Dict[str, Tensor], x: Tensor, cfg: dict, q) -> Tensor:
    window = cfg["window_size"]

    def conv(name, t, stride=1, pad=0):
        return q(F.conv3d(q(t), q(p[f"{name}.weight"]), p.get(f"{name}.bias"), stride=stride,
                          padding=pad))

    def linear(name, t):
        return q(F.linear(q(t), q(p[f"{name}.weight"]), p.get(f"{name}.bias")))

    def layer_norm(name, t):
        return q(F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5))

    def instance_norm(t):
        mean = t.mean((2, 3, 4), keepdim=True)
        var = ((t - mean) ** 2).mean((2, 3, 4), keepdim=True)
        return q((t - mean) / torch.sqrt(var + 1e-5))

    def lrelu(t):
        return F.leaky_relu(t, 0.01)

    def res_block(name, t):
        y = instance_norm(conv(f"{name}.conv2", lrelu(instance_norm(conv(f"{name}.conv1", t,
                                                                          pad=1))), pad=1))
        r = instance_norm(conv(f"{name}.conv3", t)) if f"{name}.conv3.weight" in p else t
        return lrelu(y + r)

    def up_block(name, t, skip):
        u = q(F.conv_transpose3d(q(t), q(p[f"{name}.up.weight"]), None, stride=2))
        return res_block(f"{name}.block", torch.cat([u, skip], dim=1))

    def attention(name, win, ws, heads, mask):
        nw, n, c = win.shape
        qkv = linear(f"{name}.qkv", win).view(nw, n, 3, heads, c // heads)
        qh, kh, vh = (q(qkv[:, :, i].transpose(1, 2)) for i in range(3))
        index = _bias_index(tuple(ws), window).to(win.device)
        bias = p[f"{name}.relative_position_bias_table"][index.view(-1)].view(n, n, heads)
        scores = (qh * (c // heads) ** -0.5) @ kh.transpose(-2, -1) + bias.permute(2, 0, 1)
        if mask is not None:
            scores = scores + mask[:, None]
        out = q(torch.softmax(scores, dim=-1)) @ vh
        return linear(f"{name}.proj", out.transpose(1, 2).reshape(nw, n, c))

    def swin_block(name, t, heads, ws, ss):
        dims = t.shape[1:4]
        y = layer_norm(f"{name}.norm1", t)
        y = F.pad(y, (0, 0, 0, -dims[2] % ws[2], 0, -dims[1] % ws[1], 0, -dims[0] % ws[0]))
        padded = y.shape[1:4]
        mask = None
        if any(ss):
            y = torch.roll(y, shifts=[-s for s in ss], dims=(1, 2, 3))
            mask = _region_mask(tuple(padded), tuple(ws), tuple(ss)).to(y.device)
        y = _unwindows(attention(f"{name}.attn", _windows(y, ws), ws, heads, mask), ws, padded)
        if any(ss):
            y = torch.roll(y, shifts=list(ss), dims=(1, 2, 3))
        t = t + y[:, :dims[0], :dims[1], :dims[2]]
        h = layer_norm(f"{name}.norm2", t)
        return t + linear(f"{name}.mlp.fc2", F.gelu(linear(f"{name}.mlp.fc1", h)))

    def merge(name, t):
        d, h, w = t.shape[1:4]
        t = F.pad(t, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        t = torch.cat([t[:, i::2, j::2, k::2] for i in range(2) for j in range(2)
                       for k in range(2)], dim=-1)
        return linear(f"{name}.reduction", layer_norm(f"{name}.norm", t))

    def hidden_state(t):  # channels last -> LayerNorm'd without affine, channels first
        return q(F.layer_norm(t, t.shape[-1:])).permute(0, 4, 1, 2, 3)

    t = conv("swin.patch_embed", x, stride=cfg["patch_size"]).permute(0, 2, 3, 4, 1)
    hidden = [hidden_state(t)]
    for i, (_, ws, shift) in enumerate(stage_windows(cfg, x.shape[2:])):
        for j in range(cfg["depths"][i]):
            t = swin_block(f"swin.stages.{i}.blocks.{j}", t, cfg["num_heads"][i], ws,
                           shift if j % 2 else [0, 0, 0])
        t = merge(f"swin.stages.{i}.merge", t)
        hidden.append(hidden_state(t))
    h0, h1, h2, h3, h4 = hidden
    enc0 = res_block("encoder1", x)
    enc1 = res_block("encoder2", h0)
    enc2 = res_block("encoder3", h1)
    enc3 = res_block("encoder4", h2)
    dec = up_block("decoder5", res_block("encoder10", h4), h3)
    dec = up_block("decoder4", dec, enc3)
    dec = up_block("decoder3", dec, enc2)
    dec = up_block("decoder2", dec, enc1)
    return conv("out", up_block("decoder1", dec, enc0))


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's ``state_dict`` key and shape, in the order the
    program's net registers them."""
    f, cin, w = cfg["feature_size"], cfg["in_channels"], cfg["window_size"]
    k, ps = (3, 3, 3), (cfg["patch_size"],) * 3
    shapes: Dict[str, tuple] = {"swin.patch_embed.weight": (f, cin) + ps,
                                "swin.patch_embed.bias": (f,)}
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        c = f * 2 ** i
        hidden = int(c * cfg["mlp_ratio"])
        for j in range(depth):
            b = f"swin.stages.{i}.blocks.{j}"
            shapes.update({
                f"{b}.norm1.weight": (c,), f"{b}.norm1.bias": (c,),
                f"{b}.attn.relative_position_bias_table": ((2 * w - 1) ** 3, heads),
                f"{b}.attn.qkv.weight": (3 * c, c), f"{b}.attn.qkv.bias": (3 * c,),
                f"{b}.attn.proj.weight": (c, c), f"{b}.attn.proj.bias": (c,),
                f"{b}.norm2.weight": (c,), f"{b}.norm2.bias": (c,),
                f"{b}.mlp.fc1.weight": (hidden, c), f"{b}.mlp.fc1.bias": (hidden,),
                f"{b}.mlp.fc2.weight": (c, hidden), f"{b}.mlp.fc2.bias": (c,)})
        m = f"swin.stages.{i}.merge"
        shapes.update({f"{m}.norm.weight": (8 * c,), f"{m}.norm.bias": (8 * c,),
                       f"{m}.reduction.weight": (2 * c, 8 * c)})

    def res_block(name, a, b):
        shapes[f"{name}.conv1.weight"] = (b, a) + k
        shapes[f"{name}.conv2.weight"] = (b, b) + k
        if a != b:
            shapes[f"{name}.conv3.weight"] = (b, a, 1, 1, 1)

    res_block("encoder1", cin, f)
    for name, c in (("encoder2", f), ("encoder3", 2 * f), ("encoder4", 4 * f),
                    ("encoder10", 16 * f)):
        res_block(name, c, c)
    for name, a, b in (("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
                       ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f), ("decoder1", f, f)):
        shapes[f"{name}.up.weight"] = (a, b, 2, 2, 2)
        res_block(f"{name}.block", 2 * b, b)
    shapes["out.weight"] = (cfg["out_channels"], f, 1, 1, 1)
    shapes["out.bias"] = (cfg["out_channels"],)
    return shapes
