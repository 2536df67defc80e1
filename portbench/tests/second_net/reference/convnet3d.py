"""The plain forward of a small 3D encoder-decoder: a block of [3x3x3 conv,
GroupNorm (``max(1, C // 16)`` groups, eps 1e-6), ReLU] twice, a 2x2x2
stride-2 conv down, a second block, a 2x2x2 stride-2 transposed conv up,
the first block's output concatenated first, a 1x1x1 conv and a sigmoid.
``quant`` rounds every conv's input, weight and output and every norm's
output."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def forward(p: Dict[str, Tensor], x: Tensor, cfg: dict, *, train: bool = False,
            quant: Optional[Callable[[Tensor], Tensor]] = None,
            logits: bool = False) -> Tensor:
    q = quant or (lambda t: t)

    def conv(name, x, **kw):
        return q(F.conv3d(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"], **kw))

    def block(name, x):
        for i in (1, 2):
            x = conv(f"{name}.conv{i}", x, padding=1)
            w, b = p[f"{name}.bn{i}.weight"], p[f"{name}.bn{i}.bias"]
            x = F.relu(q(F.group_norm(x, max(1, x.shape[1] // 16), w, b, 1e-6)))
        return x

    s = block("stem", x)
    y = block("mid", conv("down", s, stride=2))
    y = q(F.conv_transpose3d(q(y), q(p["up.weight"]), p["up.bias"], stride=2))
    out = conv("head", torch.cat([s, y], 1))
    return out if logits else torch.sigmoid(out)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    f, c = cfg["filters"], cfg["in_channels"]
    shapes: Dict[str, tuple] = {}

    def block(name, cin, cout):
        for i, (a, b) in enumerate(((cin, cout), (cout, cout)), 1):
            shapes[f"{name}.conv{i}.weight"] = (b, a, 3, 3, 3)
            shapes[f"{name}.conv{i}.bias"] = (b,)
            shapes[f"{name}.bn{i}.weight"] = (b,)
            shapes[f"{name}.bn{i}.bias"] = (b,)

    block("stem", c, f)
    shapes["down.weight"], shapes["down.bias"] = (2 * f, f, 2, 2, 2), (2 * f,)
    block("mid", 2 * f, 2 * f)
    shapes["up.weight"], shapes["up.bias"] = (2 * f, f, 2, 2, 2), (f,)
    shapes["head.weight"], shapes["head.bias"] = (1, 2 * f, 1, 1, 1), (1,)
    return shapes
