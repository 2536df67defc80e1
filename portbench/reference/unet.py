"""The plain U-Net: the forward pass of the JAX package's ``UNet`` (the
reference torch ``UNet`` of the ICH paper's code) written as torch
functions over a ``state_dict``-keyed dict of tensors, in float32.

Per level: [3x3 conv, norm, ReLU] twice, dropout after the encoder's
blocks; 2x max pooling down; a 2x2 stride-2 transposed conv up, the skip
concatenated first; a final 1x1 conv and a sigmoid. BatchNorm takes the
batch's biased statistics in training and updates the running averages
as flax does (``0.9 ra + 0.1 batch``, the biased variance); GroupNorm has
``max(1, C // 16)`` groups and eps 1e-6.

``quant``, where given, rounds every conv's input, weight and output and
every norm's output: the whole net held in the control's lower precision
(:mod:`portbench.reference.fp8`).
``dropout(level_path, x)``, where given, applies a level's dropout in
training.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def level_channels(cfg: dict):
    """(encoder channels per level, bottleneck channels)."""
    f = cfg["top_filter"]
    return [f * 2 ** d for d in range(cfg["depth"] - 1)], f * 2 ** (cfg["depth"] - 1)


def dropout_paths(cfg: dict):
    """The flax scope of each encoder block's Dropout, down blocks first,
    then the bottleneck's."""
    return [("encoder", f"down_{i}", "Dropout_0") for i in range(cfg["depth"] - 1)] + [
        ("encoder", "bottleneck", "Dropout_0")]


def forward(p: Dict[str, Tensor], x: Tensor, cfg: dict, *, train: bool = False,
            running: Optional[Dict[str, Tensor]] = None,
            dropout: Optional[Callable[[int, Tensor], Tensor]] = None,
            quant: Optional[Callable[[Tensor], Tensor]] = None,
            logits: bool = False) -> Tensor:
    """(B, 1, *spatial) -> (B, 1, *spatial) probabilities (or logits).
    ``running`` (BatchNorm's running averages, by ``state_dict`` key) is
    read in eval mode and updated in place in training."""
    nd = cfg["ndim"]
    conv = F.conv2d if nd == 2 else F.conv3d
    convt = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    q = quant or (lambda t: t)
    dims = [0] + list(range(2, 2 + nd))

    def conv_(name, x, pad):
        return q(conv(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"], padding=pad))

    def norm(name, x):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        shape = (1, -1) + (1,) * nd
        if cfg["norm"] == "group":
            return q(F.group_norm(x, max(1, x.shape[1] // 16), w, b, 1e-6))
        if train:
            mean = x.mean(dims)
            var = ((x - mean.view(shape)) ** 2).mean(dims)
            if running is not None:
                with torch.no_grad():
                    running[f"{name}.running_mean"].mul_(0.9).add_(0.1 * mean)
                    running[f"{name}.running_var"].mul_(0.9).add_(0.1 * var)
        else:
            mean, var = running[f"{name}.running_mean"], running[f"{name}.running_var"]
        return q((x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-5) * w.view(shape)
                 + b.view(shape))

    def block(name, x):
        x = F.relu(norm(f"{name}.bn1", conv_(f"{name}.conv1", x, 1)))
        return F.relu(norm(f"{name}.bn2", conv_(f"{name}.conv2", x, 1)))

    down, _ = level_channels(cfg)
    skips = []
    for i in range(len(down)):
        x = block(f"down_block.{i}", x)
        if train and dropout is not None:
            x = dropout(i, x)
        skips.append(x)
        x = pool(x, 2)
    x = block("bottleneck_block", x)
    if train and dropout is not None:
        x = dropout(len(down), x)
    for i in range(len(down)):
        x = q(convt(q(x), q(p[f"up_samp.{i}.weight"]), p[f"up_samp.{i}.bias"], stride=2))
        x = block(f"up_block.{i}", torch.cat([skips[-1 - i], x], dim=1))
    x = conv_("final_conv", x, 0)
    return x if logits else torch.sigmoid(x)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's ``state_dict`` key and shape, in the order the
    program's net registers them."""
    nd, k3 = cfg["ndim"], (3,) * cfg["ndim"]
    mcf = cfg["midchannels_factor"]
    down, bott = level_channels(cfg)
    shapes: Dict[str, tuple] = {}

    def block(name, cin, cout, mid):
        shapes[f"{name}.conv1.weight"] = (mid, cin) + k3
        shapes[f"{name}.conv1.bias"] = (mid,)
        shapes[f"{name}.bn1.weight"] = (mid,)
        shapes[f"{name}.bn1.bias"] = (mid,)
        shapes[f"{name}.conv2.weight"] = (cout, mid) + k3
        shapes[f"{name}.conv2.bias"] = (cout,)
        shapes[f"{name}.bn2.weight"] = (cout,)
        shapes[f"{name}.bn2.bias"] = (cout,)

    c = cfg["in_channels"]
    for i, ch in enumerate(down):
        block(f"down_block.{i}", c, ch, ch // mcf)
        c = ch
    block("bottleneck_block", c, bott, bott // mcf)
    c = bott
    for i, ch in enumerate(reversed(down)):
        shapes[f"up_samp.{i}.weight"] = (c, ch) + (2,) * nd
        shapes[f"up_samp.{i}.bias"] = (ch,)
        block(f"up_block.{i}", 2 * ch, ch, ch)
        c = ch
    shapes["final_conv.weight"] = (cfg["out_channels"], c) + (1,) * nd
    shapes["final_conv.bias"] = (cfg["out_channels"],)
    return shapes


def running_stats(cfg: dict, device) -> Dict[str, Tensor]:
    """BatchNorm's running averages at their start (means 0, variances 1);
    empty for GroupNorm."""
    if cfg["norm"] != "batch":
        return {}
    out = {}
    for k, s in param_shapes(cfg).items():
        if ".bn" in k and k.endswith(".weight"):
            base = k[: -len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(s, device=device)
            out[f"{base}.running_var"] = torch.ones(s, device=device)
    return out
