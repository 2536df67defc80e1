"""Free-form inpainting masks and FCDD's synthetic ellipses on the device
(counterpart of :mod:`ich_tpu.ops.masks`: ``random_ff_mask``,
``random_ff_masks``, ``draw_ellipses``, ``draw_ellipses_batch``).

Each mask is split into a *draw* and a *render*:

- :func:`draw_ff_masks` takes a jax.random key and draws from it, for a
  whole batch at once, exactly what the JAX package's ``random_ff_masks``
  draws from it: the stroke count, each stroke's vertex count, brush width,
  start point and base angle, each segment's angle and length, and the
  salt-and-pepper discs (``randint``'s exclusive upper bounds, start points
  ~ N(dim/2, dim/8), base angles uniform in [0, 6.28));
- :func:`render_ff_masks` takes those tensors to the (B, H, W) float32 mask
  on their device: the polyline walk (segment k turned by ``+pi`` when k is
  even; the y step ``len * cos(a)``, the x step ``len * sin(a)``), every
  pixel's distance to every valid segment against half the brush width, and
  the discs.

Counts are padded to their maxima with validity masks, as in the JAX
package, so the render has static shapes.

The ellipses are split the same way: :func:`draw_ellipse_params` draws,
for a batch, what the JAX package's ``draw_ellipses_batch`` draws from the
same key: the count ``n`` in ``[lo, hi)`` and ``hi - 1`` slots of centres
~ N(dim/2, dim/6), a major axis uniform in its range, a minor axis uniform
up to ``min(minor_hi, major)``, a rotation and an intensity;
:func:`render_ellipses` draws them in slot order on a zero image, each
later ellipse overwriting the earlier ones, then adds the optional noise
inside them.

The draws run through :mod:`ich_tpu_torch.utils.rng` with the keys of
every mask or image, and of the variables of one shape, batched into one
call: on the host, then one copy each to ``device``, but for the
ellipses' noise, a (B, H, W) draw that rng computes on ``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ich_tpu_torch.utils import rng

Draws = Dict[str, torch.Tensor]


def _to(draws: Draws, device) -> Draws:
    return {k: rng.to_device(v, device) for k, v in draws.items()}


def _keys(key, batch: Optional[int]) -> torch.Tensor:
    """``split(key, batch)``, or ``key`` itself as a batch of one for
    ``batch=None``."""
    return torch.as_tensor(key)[None] if batch is None else rng.split(key, batch)


def draw_ff_masks(
    key,
    batch: Optional[int],
    shape: Tuple[int, int],
    n_draw: Tuple[int, int] = (1, 4),
    vertex: Tuple[int, int] = (5, 15),
    brush_width: Tuple[int, int] = (10, 25),
    angle: Tuple[float, float] = (0.5, 2.0),
    length: Tuple[int, int] = (10, 40),
    n_salt_pepper: Tuple[int, int] = (0, 10),
    salt_pepper_radius: Tuple[int, int] = (1, 5),
    device=None,
) -> Draws:
    """The random parameters of ``batch`` masks of ``shape`` on ``device``
    (the CPU by default), from the JAX package's key tree: mask i takes
    ``split(key, batch)[i]`` (``batch=None``: one mask from ``key`` itself,
    as ``random_ff_mask``), split into ``kd, kv, kb, ks, kw_, kn, ka, kl,
    ksp``; the discs draw from ``split(ksp, 4)``. Integer counts are int64,
    the rest float32; ``D = n_draw[1] - 1`` strokes, ``V = vertex[1] - 1``
    segments a stroke and ``S = n_salt_pepper[1] - 1`` discs at most (no
    disc keys when ``S <= 0``)."""
    h, w = shape
    d, v = n_draw[1] - 1, vertex[1] - 1
    s = max(n_salt_pepper[1] - 1, 0)
    kd, kv, kb, ks, kw_, kn, ka, kl, ksp = rng.split(_keys(key, batch), 9).unbind(-2)
    # draws of one shape in one pass each, their keys stacked and their
    # bounds broadcast: each is the draw its own key gives
    out = {"n_strokes": rng.randint(kd, (), n_draw[0], n_draw[1])}
    out["n_vert"], out["width"] = rng.randint(
        torch.stack([kv, kb]), (d,), _bounds(vertex[0], brush_width[0]),
        _bounds(vertex[1], brush_width[1])).unbind(0)
    sx, sy = rng.normal(torch.stack([ks, kw_]), (d,)).unbind(0)
    out["sx"] = sx * (w / 8) + w / 2
    out["sy"] = sy * (h / 8) + h / 2
    out["beta"] = rng.uniform(kn, (d,), 0.0, 6.28)
    out["angs"] = rng.uniform(ka, (d, v), angle[0], angle[1])
    out["lens"] = rng.randint(kl, (d, v), length[0], length[1]).to(torch.float32)
    if s > 0:
        k1, k2, k3, k4 = rng.split(ksp, 4).unbind(-2)
        out["n_sp"] = rng.randint(k1, (), n_salt_pepper[0], n_salt_pepper[1])
        discs = rng.randint(torch.stack([k2, k3, k4]), (s,), _bounds(0, 0, salt_pepper_radius[0]),
                            _bounds(h, w, salt_pepper_radius[1])).to(torch.float32)
        out["cy"], out["cx"], out["r"] = discs.unbind(0)
    return _to(out, device)


def _bounds(*values, dtype=torch.int64) -> torch.Tensor:
    """Per-variable bounds (V, 1, 1) of a draw whose V keys are stacked
    first over (B, n) values."""
    return torch.tensor(values, dtype=dtype).reshape(-1, 1, 1)


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


def random_ff_masks(key, batch: int, shape: Tuple[int, int], device=None,
                    **kw) -> torch.Tensor:
    """A batch of free-form masks (B, H, W) on ``device``: draw, then
    render."""
    return render_ff_masks(draw_ff_masks(key, batch, shape, device=device, **kw), shape)


def random_ff_mask(key, shape: Tuple[int, int], device=None, **kw) -> torch.Tensor:
    """One free-form mask (H, W), drawn from ``key`` itself as the JAX
    package's ``random_ff_mask(key)`` draws it."""
    return render_ff_masks(draw_ff_masks(key, None, shape, device=device, **kw), shape)[0]


def draw_ellipse_params(
    key,
    batch: Optional[int],
    shape: Tuple[int, int],
    n_ellipse: Tuple[int, int] = (1, 10),
    major_axis: Tuple[int, int] = (1, 25),
    minor_axis: Tuple[int, int] = (1, 25),
    rotation: Tuple[float, float] = (0.0, 2 * math.pi),
    intensity: Tuple[float, float] = (0.1, 1.0),
    noise: Optional[float] = None,
    device=None,
) -> Draws:
    """The random parameters of ``batch`` ellipse images of ``shape``
    (reference ``draw_ellipses``, ``datasets.py:685-719``) on ``device``,
    from the JAX package's key tree: image i takes ``split(key, batch)[i]``
    (``batch=None``: one image from ``key`` itself, as ``draw_ellipses``),
    split into ``kn, kc, kaxis, krot, kint, knoise``. ``n`` (B,) int64, then
    (B, M) float32 with ``M = n_ellipse[1] - 1``: ``cy`` (from ``kc``),
    ``cx`` (``fold_in(kc, 1)``), ``major`` (the column radius, ``kaxis``),
    ``minor`` (the row radius, never above the major, ``fold_in(kaxis,
    1)``), ``theta``, ``value``; with ``noise``, ``noise`` (B, H, W),
    already scaled."""
    h, w = shape
    m = n_ellipse[1] - 1
    kn, kc, kaxis, krot, kint, knoise = rng.split(_keys(key, batch), 6).unbind(-2)
    out = {"n": rng.randint(kn, (), n_ellipse[0], n_ellipse[1])}
    cy, cx = rng.normal(torch.stack([kc, rng.fold_in(kc, 1)]), (m,)).unbind(0)
    out["cy"] = cy * (h / 6.0) + h / 2.0
    out["cx"] = cx * (w / 6.0) + w / 2.0
    out["major"] = rng.uniform(kaxis, (m,), float(major_axis[0]), float(major_axis[1]))
    out["minor"] = rng.uniform(rng.fold_in(kaxis, 1), (m,), float(minor_axis[0]),
                               torch.clamp(out["major"], max=float(minor_axis[1])))
    out["theta"], out["value"] = rng.uniform(
        torch.stack([krot, kint]), (m,), _bounds(rotation[0], intensity[0], dtype=torch.float32),
        _bounds(rotation[1], intensity[1], dtype=torch.float32)).unbind(0)
    out = _to(out, device)
    if noise is not None:
        out["noise"] = rng.normal(knoise, (h, w), device) * noise
    return out


def render_ellipses(draws: Draws, shape: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) float32 ellipse images from :func:`draw_ellipse_params`'s
    tensors (or the same keys taken from JAX): zero background; pixel (y, x)
    lies in ellipse i when ``(yr / minor)^2 + (xr / major)^2 <= 1`` for
    its offsets from the centre rotated by ``theta`` (the radii at least
    1e-3), and takes its value, slot by slot, so that later ellipses
    overwrite earlier ones."""
    h, w = shape
    cy = draws["cy"].to(torch.float32)
    b, m = cy.shape
    dev = cy.device
    cx = draws["cx"].to(torch.float32)
    ra = torch.clamp(draws["minor"].to(torch.float32), min=1e-3)
    rb = torch.clamp(draws["major"].to(torch.float32), min=1e-3)
    th = draws["theta"].to(torch.float32)
    cos, sin = torch.cos(th), torch.sin(th)
    val = draws["value"].to(torch.float32)
    py = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    px = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w)
    out = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
    for i in range(m):
        def col(t):
            return t[:, i].reshape(b, 1, 1)

        dy, dx = py - col(cy), px - col(cx)
        yr = dy * col(cos) + dx * col(sin)
        xr = -dy * col(sin) + dx * col(cos)
        inside = ((yr / col(ra)) ** 2 + (xr / col(rb)) ** 2 <= 1.0) & (i < draws["n"]).reshape(
            b, 1, 1)
        out = torch.where(inside, col(val), out)
    if "noise" in draws:
        out = torch.where(out > 0, torch.clamp(out + draws["noise"].to(torch.float32), 0.0, 1.0),
                          out)
    return out


def draw_ellipses_batch(key, batch: int, shape: Tuple[int, int], device=None,
                        **kw) -> torch.Tensor:
    """A batch of ellipse images (B, H, W) on ``device``: draw, then
    render."""
    return render_ellipses(draw_ellipse_params(key, batch, shape, device=device, **kw), shape)


def draw_ellipses(key, shape: Tuple[int, int], device=None, **kw) -> torch.Tensor:
    """One ellipse image (H, W), drawn from ``key`` itself as the JAX
    package's ``draw_ellipses(key)`` draws it."""
    return render_ellipses(draw_ellipse_params(key, None, shape, device=device, **kw), shape)[0]
