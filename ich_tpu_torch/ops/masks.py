"""Free-form inpainting masks on the device (counterpart of
:mod:`ich_tpu.ops.masks`: ``random_ff_mask``, ``random_ff_masks``).

Each mask is split into a *draw* and a *render*:

- :func:`draw_ff_masks` takes a ``torch.Generator`` and draws, for a whole
  batch at once, the stroke count, each stroke's vertex count, brush width,
  start point and base angle, each segment's angle and length, and the
  salt-and-pepper discs, with the JAX package's distributions: ``randint``'s
  exclusive upper bounds, start points ~ N(dim/2, dim/8), base angles
  uniform in [0, 6.28);
- :func:`render_ff_masks` takes those tensors to the (B, H, W) float32 mask
  on their device: the polyline walk (segment k turned by ``+pi`` when k is
  even; the y step ``len * cos(a)``, the x step ``len * sin(a)``), every
  pixel's distance to every valid segment against half the brush width, and
  the discs.

Counts are padded to their maxima with validity masks, as in the JAX
package, so the render has static shapes. The JAX draws come from
``jax.random`` and cannot be replayed by a torch generator: the tests hand
the render JAX's draws. ``draw_ellipses`` (FCDD's anomalies) is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Draws = Dict[str, torch.Tensor]


def draw_ff_masks(
    gen: torch.Generator,
    batch: int,
    shape: Tuple[int, int],
    n_draw: Tuple[int, int] = (1, 4),
    vertex: Tuple[int, int] = (5, 15),
    brush_width: Tuple[int, int] = (10, 25),
    angle: Tuple[float, float] = (0.5, 2.0),
    length: Tuple[int, int] = (10, 40),
    n_salt_pepper: Tuple[int, int] = (0, 10),
    salt_pepper_radius: Tuple[int, int] = (1, 5),
) -> Draws:
    """The random parameters of ``batch`` masks of ``shape``, drawn from
    ``gen`` on its device in a fixed order (the names below, in order).
    Integer counts are int64, the rest float32; ``D = n_draw[1] - 1``
    strokes, ``V = vertex[1] - 1`` segments a stroke and ``S =
    n_salt_pepper[1] - 1`` discs at most (no disc keys when ``S <= 0``)."""
    h, w = shape
    dev = gen.device
    d, v = n_draw[1] - 1, vertex[1] - 1
    s = max(n_salt_pepper[1] - 1, 0)

    def randint(lo, hi, size):
        return torch.randint(int(lo), int(hi), size, generator=gen, device=dev)

    def uniform(lo, hi, size):
        return torch.rand(size, generator=gen, device=dev) * (hi - lo) + lo

    def normal(size):
        return torch.randn(size, generator=gen, device=dev)

    out = {"n_strokes": randint(n_draw[0], n_draw[1], (batch,)),
           "n_vert": randint(vertex[0], vertex[1], (batch, d)),
           "width": randint(brush_width[0], brush_width[1], (batch, d))}
    out["sx"] = normal((batch, d)) * (w / 8) + w / 2
    out["sy"] = normal((batch, d)) * (h / 8) + h / 2
    out["beta"] = uniform(0.0, 6.28, (batch, d))
    out["angs"] = uniform(float(angle[0]), float(angle[1]), (batch, d, v))
    out["lens"] = randint(length[0], length[1], (batch, d, v)).to(torch.float32)
    if s > 0:
        out["n_sp"] = randint(n_salt_pepper[0], n_salt_pepper[1], (batch,))
        out["cy"] = randint(0, h, (batch, s)).to(torch.float32)
        out["cx"] = randint(0, w, (batch, s)).to(torch.float32)
        out["r"] = randint(salt_pepper_radius[0], salt_pepper_radius[1],
                           (batch, s)).to(torch.float32)
    return out


def render_ff_masks(draws: Draws, shape: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) float32 masks, 1 = region to inpaint, from
    :func:`draw_ff_masks`'s tensors (or the same keys taken from JAX)."""
    h, w = shape
    angs = draws["angs"].to(torch.float32)
    b, d, v = angs.shape
    dev = angs.device
    # the polyline walk: segment k alternates direction (+pi on even k)
    turn = torch.where(torch.arange(v, device=dev) % 2 == 0, math.pi, 0.0).to(torch.float32)
    a = draws["beta"].to(torch.float32)[..., None] + angs + turn
    lens = draws["lens"].to(torch.float32)
    sy, sx = draws["sy"].to(torch.float32)[..., None], draws["sx"].to(torch.float32)[..., None]
    ys = torch.cat([sy, sy + torch.cumsum(lens * torch.cos(a), dim=-1)], dim=-1)
    xs = torch.cat([sx, sx + torch.cumsum(lens * torch.sin(a), dim=-1)], dim=-1)

    valid = ((torch.arange(d, device=dev)[None, :, None] < draws["n_strokes"][:, None, None])
             & (torch.arange(v, device=dev)[None, None, :] < draws["n_vert"][..., None]))
    y0, x0 = ys[..., :-1].reshape(b, 1, 1, -1), xs[..., :-1].reshape(b, 1, 1, -1)
    dy = ys[..., 1:].reshape(b, 1, 1, -1) - y0
    dx = xs[..., 1:].reshape(b, 1, 1, -1) - x0
    half_w = (draws["width"].to(torch.float32)[..., None].expand(b, d, v) / 2.0).reshape(b, 1, 1, -1)
    py = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1, 1)
    px = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w, 1)

    # distance of every pixel to every segment (B, H, W, D * V)
    len2 = dy * dy + dx * dx + 1e-8
    t = torch.clamp(((py - y0) * dy + (px - x0) * dx) / len2, 0.0, 1.0)
    dist = torch.sqrt((py - (y0 + t * dy)) ** 2 + (px - (x0 + t * dx)) ** 2)
    mask = ((dist <= half_w) & valid.reshape(b, 1, 1, -1)).any(dim=-1)

    if "n_sp" in draws:
        s = draws["cy"].shape[1]
        on = (torch.arange(s, device=dev)[None, :] < draws["n_sp"][:, None]).reshape(b, 1, 1, s)
        cy, cx = draws["cy"].reshape(b, 1, 1, s), draws["cx"].reshape(b, 1, 1, s)
        r = draws["r"].reshape(b, 1, 1, s)
        disc = ((py - cy) ** 2 + (px - cx) ** 2 <= r ** 2) & on
        mask = mask | disc.any(dim=-1)
    return mask.to(torch.float32)


def random_ff_masks(gen: torch.Generator, batch: int, shape: Tuple[int, int],
                    **kw) -> torch.Tensor:
    """A batch of free-form masks (B, H, W) on ``gen``'s device: draw, then
    render."""
    return render_ff_masks(draw_ff_masks(gen, batch, shape, **kw), shape)


def random_ff_mask(gen: torch.Generator, shape: Tuple[int, int], **kw) -> torch.Tensor:
    """One free-form mask (H, W)."""
    return random_ff_masks(gen, 1, shape, **kw)[0]
