"""GroupNorm followed by ReLU, fused: ``relu(group_norm(x))``.

A ``ConvBlock`` whose norm is a GroupNorm (the 3D nets) calls this in
place of ``F.relu(norm(y))``. The norm's parameters are cast to ``x``'s
dtype at use, as :func:`ich_tpu_torch.models.layers._params_as` casts
them: a bf16 input normalises with bf16-rounded ``weight`` and ``bias``.
Their gradients come back in their own dtype (float32 parameters get
float32 gradients: the cast passes the gradient through).

- :func:`group_norm_relu_plain`: the plain PyTorch version,
  ``F.relu(F.group_norm(x, groups, weight.to(x.dtype), bias.to(x.dtype),
  eps))``, and :func:`group_norm_relu_backward_plain`, the backward
  kernels' arithmetic in float32.
- :func:`group_norm_relu`: an autograd function. A CPU tensor runs the
  plain versions; a CUDA tensor launches the kernels of
  ``csrc/group_norm.cu`` on the current stream (statistics, then the
  apply; the per-channel sums, then dx), and a dtype, rank or layout they
  do not take, or a failed build or launch, raises. The backward saves
  ``x`` and the statistics, nothing of the output: it recomputes the
  ReLU's mask. ``launches`` counts its launches, forward and backward.

The kernels replace no TPU kernel: the JAX package's ``FlatGroupNorm`` is
left to XLA. They exist because torch's CUDA GroupNorm reduces with one
block a (batch, group) row, which leaves most of the card idle at the 3D
net's one to eight groups, and applies the norm, the ReLU and their
gradients in separate passes over the activations.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

# Launches of the group_norm kernels (forward and backward) in this process.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 256  # csrc/group_norm.cu's largest block
_MIN_ITERS = 8  # vectors a thread in a segment at least
_MAX_SEGMENTS = 32  # a plane's segments at most, for long planes


def group_norm_relu_plain(x: torch.Tensor, groups: int, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``relu(group_norm(x))`` in plain PyTorch, the parameters in ``x``'s
    dtype."""
    return F.relu(F.group_norm(x, groups, weight.to(x.dtype), bias.to(x.dtype), eps))


def _stats_plain(x: torch.Tensor, groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (n, group) row's mean and ``1 / sqrt(var + eps)`` (biased
    variance) in float32, flat (N * groups,)."""
    var, mean = torch.var_mean(x.reshape(x.shape[0] * groups, -1).to(torch.float32), -1,
                               correction=0)
    return mean, 1.0 / torch.sqrt(var + eps)


def group_norm_relu_backward_plain(dy: torch.Tensor, x: torch.Tensor, groups: int,
                                   weight: torch.Tensor, bias: torch.Tensor,
                                   mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dweight, dbias) of ``relu(group_norm(x))`` from ``dy`` and the
    forward's statistics, in float32 as the backward kernels compute them:
    with ``a = rstd w``, ``b = bias - mean a`` and ``g = dy`` where ``a x +
    b > 0``, ``dbias = sum g``, ``dweight = sum g xhat`` and, over a row of
    ``L`` elements, ``dx = a g - rstd / L (sum_c w_c sum g + xhat sum_c w_c
    sum g xhat)``. ``b`` and the mask's ``a x + b`` are each rounded once,
    as the kernels' ``fmaf`` rounds them (exact products in float64), so
    the mask is the kernels' own from the same statistics."""
    n, c = x.shape[:2]
    shape = (n, groups, c // groups, -1)
    xf, gf = x.reshape(shape).to(torch.float32), dy.reshape(shape).to(torch.float32)
    w = weight.to(x.dtype).to(torch.float32).reshape(1, groups, -1, 1)
    bb = bias.to(x.dtype).to(torch.float64).reshape(1, groups, -1, 1)
    mu, r = mean.reshape(n, groups, 1, 1), rstd.reshape(n, groups, 1, 1)
    a = r * w
    b = (bb - mu.to(torch.float64) * a.to(torch.float64)).to(torch.float32)
    g = torch.where(torch.addcmul(b.to(torch.float64), a.to(torch.float64),
                                  xf.to(torch.float64)) > 0, gf, 0.0)
    xhat = (xf - mu) * r
    s1, s2 = g.sum(-1), (g * xhat).sum(-1)  # (N, G, C/G)
    big_a = (s1 * w[..., 0]).sum(-1)[..., None, None]
    big_b = (s2 * w[..., 0]).sum(-1)[..., None, None]
    dx = a * g - r / xf[0, 0].numel() * (big_a + xhat * big_b)
    return (dx.to(x.dtype).reshape(x.shape), s2.sum(0).reshape(c).to(weight.dtype),
            s1.sum(0).reshape(c).to(bias.dtype))


def _check(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_relu wants float32 or bfloat16 on the card; got {x.dtype}")
    if x.dim() not in (4, 5) or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("group_norm_relu wants a non-empty contiguous (N, C, H, W) or "
                         f"(N, C, D, H, W) tensor on the card; got {tuple(x.shape)} with "
                         f"strides {x.stride()}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_relu: {c} channels in {groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.device != x.device or p.dtype not in (torch.float32, x.dtype):
            raise ValueError(f"group_norm_relu: {name} {tuple(p.shape)} {p.dtype} on {p.device} "
                             f"for {c} channels of {x.dtype} on {x.device}")


def _geometry(s: int, itemsize: int, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    """(elements a load, threads a block, elements a segment, segments a
    plane) for planes of ``s`` elements: 16-byte loads where ``s`` and
    every pointer allow; blocks of 256 threads, or of as few whole warps
    as give each thread ``_MIN_ITERS`` loads of a short plane;
    ``_MIN_ITERS`` loads a thread a segment, more on planes too long for
    ``_MAX_SEGMENTS`` segments."""
    vec = 16 // itemsize
    if s % vec or any(t.data_ptr() % 16 for t in tensors):
        vec = 1
    loads = -(-s // vec)
    threads = min(_MAX_THREADS, 32 * -(-loads // (32 * _MIN_ITERS)))
    iters = max(_MIN_ITERS, -(-loads // (threads * _MAX_SEGMENTS)))
    chunk = threads * vec * iters
    return vec, threads, chunk, -(-s // chunk)


def _current(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _forward(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
             eps: float):
    """(y, mean, rstd) from the kernels, on ``x``'s card."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"group_norm_relu: unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _forward(x, groups, weight, bias, eps)
    from ich_tpu_torch.kernels._build import load_library

    _check(x, groups, weight, bias)
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    y = torch.empty_like(x)
    vec, threads, chunk, p = _geometry(s, x.element_size(), x, y)
    buf = torch.empty(n * c * p * 2 + 2 * n * groups, dtype=torch.float32, device=dev)
    mean, rstd = buf[-2 * n * groups:].view(2, n * groups)
    w, b = (t.to(torch.float32).contiguous() for t in (weight, bias))
    err = load_library().group_norm_relu_forward(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), buf.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), _DTYPES[x.dtype], n, c, s, groups, chunk, vec, threads, eps,
        _current(dev))
    if err != 0:
        raise RuntimeError(f"group_norm_relu forward launch failed: CUDA error {err}")
    launches += 2
    return y, mean, rstd


def _backward(dy: torch.Tensor, x: torch.Tensor, groups: int, weight: torch.Tensor,
              bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dweight, dbias) from the kernels, on ``x``'s card."""
    global launches
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _backward(dy, x, groups, weight, bias, mean, rstd)
    from ich_tpu_torch.kernels._build import load_library

    dy = dy.contiguous()  # autograd's gradient, in whatever layout it came
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    dx = torch.empty_like(x)
    vec, threads, chunk, p = _geometry(s, x.element_size(), x, dy, dx)
    part = torch.empty(n * c * p * 2, dtype=torch.float32, device=dev)
    dw, db = torch.empty(2, c, dtype=torch.float32, device=dev)
    w, b = (t.to(torch.float32).contiguous() for t in (weight, bias))
    err = load_library().group_norm_relu_backward(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), w.data_ptr(), b.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(), _DTYPES[x.dtype], n, c,
        s, groups, chunk, vec, threads, _current(dev))
    if err != 0:
        raise RuntimeError(f"group_norm_relu backward launch failed: CUDA error {err}")
    launches += 2
    return dx, dw.to(weight.dtype), db.to(bias.dtype)


class _GroupNormReLU(torch.autograd.Function):
    """The plain versions on the CPU, the kernels on the card. The CPU's
    statistics are taken in the backward, so a forward without gradients
    runs torch's two calls alone."""

    @staticmethod
    def forward(ctx, x, groups, weight, bias, eps):
        if x.device.type == "cpu":
            y, mean, rstd = group_norm_relu_plain(x, groups, weight, bias, eps), None, None
        else:
            y, mean, rstd = _forward(x, groups, weight, bias, eps)
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    @once_differentiable  # the kernels' backward is not itself differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        if x.device.type == "cpu":
            mean, rstd = _stats_plain(x, ctx.groups, ctx.eps)
            fn = group_norm_relu_backward_plain
        else:
            fn = _backward
        dx, dw, db = fn(dy, x, ctx.groups, weight, bias, mean, rstd)
        return dx, None, dw, db, None


def group_norm_relu(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """``relu(group_norm(x, groups, weight, bias, eps))`` of a (N, C,
    *spatial) tensor, the parameters cast to ``x``'s dtype; differentiable
    in ``x``, ``weight`` and ``bias``. On the card: a contiguous float32 or
    bfloat16 tensor of rank 4 or 5, float32 or ``x.dtype`` parameters,
    through the kernels."""
    return _GroupNormReLU.apply(x, int(groups), weight, bias, float(eps))
