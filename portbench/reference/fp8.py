"""The control's precision for a bf16 configuration: fp8 with a scale per
tensor. Each tensor that the plain net holds (a conv's input, weight and
output, a norm's output) is scaled so that its largest magnitude lands on
e4m3's largest (448), rounded to e4m3 and scaled back; in the backward its
gradient is rounded alike to e5m2 (largest 57344). The arithmetic between
the roundings runs in float32."""

from __future__ import annotations

import torch

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = _MAX[dtype] / t.abs().amax().float().clamp(min=1e-30)
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def quant_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3, its gradient to e5m2."""
    return _Fp8.apply(t)
