"""Keyed dropout: flax's ``nn.Dropout`` with XLA's mask stream.

The JAX package's dropout draws ``bernoulli(key, 1 - rate, x.shape)`` from
the ``rbg`` key that flax gives the Dropout, ``fold_in(dropout_key(step
key), fold)`` with ``fold`` the SHA-1 word of its scope path
(:func:`ich_tpu_torch.models.init.flax_fold`). The draw is XLA's
Philox4x32-10 stream (:func:`ich_tpu_torch.utils.rng.philox_bits`) over the
channels-last tensor in its flat order, and the output ``select(u < keep,
x / keep, 0)``, with ``u`` the top 23 bits of each word as a float in
[0, 1) and ``keep`` taken in ``x``'s dtype for the divide (bf16 rounds it)
and in float32 for the compare. A key here is ``(s0, s1, fold)``: the
step's threefry dropout key and the fold word. The port's tensors are
channels-first, so both versions index the stream by each element's
channels-last position; ``offset`` shifts it, so that a rank's slice of a
global batch draws its rows of the global batch's mask.

- :func:`keyed_dropout_plain`: the plain PyTorch version.
- :func:`keyed_dropout`: an autograd function whose backward is the same
  function of the gradient (the derivative of ``select(m, x / keep, 0)``
  is ``select(m, g / keep, 0)``), so no mask is saved. A CPU tensor runs
  the plain version; a CUDA tensor launches the kernel of
  ``csrc/dropout.cu`` on the current stream, and a failed build or launch
  raises. ``launches`` counts its launches, forward and backward.

The kernel replaces no TPU kernel: the JAX package leaves the mask to XLA.
It exists because no torch call draws XLA's stream, and ten Philox rounds
in int64 torch ops cost some 150 passes over the step's largest tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ich_tpu_torch.utils import rng

# Launches of the dropout kernel (forward and backward) in this process.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _thresholds(rate: float, dtype: torch.dtype):
    """(keep in float32 for the compare, the divisor: keep rounded to
    ``dtype`` as flax's ``x / keep_prob`` rounds it, as a float)."""
    keep = 1.0 - float(rate)
    return float(np.float32(keep)), float(torch.tensor(keep, dtype=dtype))


def _check_args(x: torch.Tensor, key: Sequence[int], rate: float, offset: int) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"keyed_dropout wants float32 or bfloat16; got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"keyed_dropout wants (B, C, *spatial); got {tuple(x.shape)}")
    if len(key) != 3:
        raise ValueError(f"keyed_dropout wants a key (s0, s1, fold); got {key}")
    if not 0.0 <= rate <= 1.0 or offset < 0:
        raise ValueError(f"keyed_dropout: rate {rate}, offset {offset}")


def flax_dropout_key(key: Sequence[int]) -> Tuple[int, int, int, int]:
    """The ``rbg`` key of ``(s0, s1, fold)``: ``fold_in(dropout_key((s0,
    s1)), fold)``, on the host."""
    s0, s1, fold = key
    return rng.rbg_fold_in(rng.rbg_key(torch.tensor([s0, s1])), fold)


def keyed_dropout_plain(x: torch.Tensor, key: Sequence[int], rate: float,
                        offset: int = 0) -> torch.Tensor:
    """Plain PyTorch keyed dropout of a (B, C, *spatial) tensor: the
    Dropout's ``rbg`` key from ``key`` on the host, the channels-last
    order's ``philox_bits`` from ``offset``, the compare and the divide in
    float32, rounded once to ``x``'s dtype, back in ``x``'s layout."""
    _check_args(x, key, rate, offset)
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep, div = _thresholds(rate, x.dtype)
    xl = x.movedim(1, -1)
    bits = rng.philox_bits(flax_dropout_key(key), xl.numel(), offset, x.device).reshape(xl.shape)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # a divisor on the tensor's device: torch divides a CUDA tensor by a
    # host scalar as a product with its reciprocal, which rounds otherwise
    div = torch.tensor(div, dtype=torch.float32, device=x.device)
    y = torch.where(u < keep, xl.to(torch.float32) / div, 0.0).to(x.dtype)
    return y.movedim(-1, 1)


def _folded_strides(x: torch.Tensor):
    """(batch, channel, spatial) strides of a (B, C, *spatial) tensor whose
    spatial axes fold into one stride, as a dense NCHW or channels-last
    tensor's do; None for any other."""
    if x.is_contiguous():
        return x.stride(0), x.stride(1), 1
    ss = 1
    for d in range(x.dim() - 1, 1, -1):
        if x.shape[d] > 1:
            ss = x.stride(d)
            break
    inner = 1
    for d in range(x.dim() - 1, 1, -1):
        if x.shape[d] > 1 and x.stride(d) != ss * inner:
            return None
        inner *= x.shape[d]
    return x.stride(0), x.stride(1), ss


def _launch(x: torch.Tensor, key: Sequence[int], rate: float, offset: int) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor; the output has ``x``'s
    strides (a copy's, for a tensor that is not dense with foldable
    spatial axes). The host work is kept to some twenty microseconds: a
    step launches it ten times, and a small net's step is host-bound."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"keyed_dropout: unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, key, rate, offset)
    from ich_tpu_torch.kernels._build import load_library

    strides = _folded_strides(x)
    y = torch.empty_like(x)
    if strides is None or y.stride() != x.stride():
        x = x.contiguous()
        y = torch.empty_like(x)
        strides = _folded_strides(x)
    if x.numel() == 0:
        return y
    keep, div = _thresholds(rate, x.dtype)
    err = load_library().keyed_dropout(
        x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], x.shape[0], x.shape[1],
        math.prod(x.shape[2:]), *strides, *key, offset, keep, div,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"keyed_dropout launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y


def _apply(x: torch.Tensor, key: Sequence[int], rate: float, offset: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return keyed_dropout_plain(x, key, rate, offset)
    if rate == 1.0:
        return torch.zeros_like(x)
    return _launch(x, key, rate, offset)


class _KeyedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate, offset):
        ctx.args = (key, rate, offset)
        return _apply(x, key, rate, offset)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.args), None, None, None


def keyed_dropout(x: torch.Tensor, key: Sequence[int], rate: float,
                  offset: int = 0) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` in train mode on a (B, C, *spatial)
    float32 or bfloat16 tensor, its mask words taken from the stream of the
    Dropout's ``rbg`` key (``key`` = ``(s0, s1, fold)``) at the
    channels-last positions ``offset ..``. Differentiable; bit-equal
    between the CPU's plain version and the card's kernel, which derives
    the ``rbg`` key itself."""
    _check_args(x, key, rate, offset)
    if rate == 0.0:
        return x
    return _KeyedDropout.apply(x, tuple(int(k) & 0xFFFFFFFF for k in key), float(rate),
                               int(offset))
