"""Swin UNETR (``ich_tpu_torch.models.swin_unetr.SwinUNETR``), as the drivers
need it: the program's net, the seeded weights and the final bias's
calibration, the plain reference (``reference/swin_unetr.py``), the
FLOPs, the attention core's least work and the cut for a CPU test."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.common import weights
from portbench.common.flops import forward_flops
from portbench.reference import swin_unetr as ref
from portbench.reference.train import exact_fp32

forward = ref.forward
param_shapes = ref.param_shapes

TINY_PATCH = 32  # stage resolutions 16, 8, 4, 2: padding and shift, then the window clamp


def tiny(cfg: dict) -> dict:
    """What a CPU test changes in the net: 12 features, so heads of 4."""
    return {"feature_size": 12}


def build(cfg: dict, device, dtype=None) -> torch.nn.Module:
    """The program's net on ``device``, computing in ``dtype`` (default:
    the configuration's ``compute_dtype``)."""
    from ich_tpu_torch.models.swin_unetr import SwinUNETR

    with torch.device(device):
        return SwinUNETR(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                         feature_size=cfg["feature_size"], depths=tuple(cfg["depths"]),
                         num_heads=tuple(cfg["num_heads"]), window_size=cfg["window_size"],
                         patch_size=cfg["patch_size"], mlp_ratio=cfg["mlp_ratio"],
                         dtype=dtype or getattr(torch, cfg["compute_dtype"]))


def _init(name: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    """Swin's rule for the transformer: linears, the bias table and the
    embedding normal with std 0.02 (timm's ``trunc_normal_`` at its default
    bounds of +-2, a hundred standard deviations out), LayerNorm 1 and 0,
    biases 0; the decoder's convs He-normal (a transposed conv's fan in: its
    input channels)."""
    if name.endswith(".bias"):
        return torch.zeros_like(z)
    if ".norm" in name:
        return torch.ones_like(z)
    if name.startswith("swin."):
        return 0.02 * z
    fan_in = shape[0] if name.endswith(".up.weight") else z[0].numel()
    return z * (2.0 / fan_in) ** 0.5


def make_weights(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Float32 weights drawn from ``gen``, keyed as the program's
    ``state_dict``."""
    return weights.draw(param_shapes(cfg), _init, gen, device)


@torch.no_grad()
def calibrate_final_bias(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
                         train: bool) -> None:
    """Shift ``out.bias`` by the 0.9 quantile of the reference's logits on
    ``x`` (a (B, 1, *spatial) batch), in float32."""
    with exact_fp32():
        logits = forward(w, x, cfg, train=train, logits=True)
    weights.calibrate_bias(w, "out.bias", logits)


def flops(cfg: dict, batch: int, spatial, train: bool) -> float:
    """FLOPs of the net's forward on (batch, 1, *spatial), with the
    backward of every parameter and activation where ``train``."""
    return forward_flops(lambda p, x: forward(p, x, cfg, train=train), param_shapes(cfg),
                         (batch, cfg["in_channels"]) + tuple(spatial), train)


def attention_work(cfg: dict, batch: int, spatial) -> Dict[str, float]:
    """The attention cores' least work in one call of the net on ``batch``
    patches of ``spatial``, over every block: ``flops``, the two products
    (``4 tokens N C`` a block, over the zero-padded tokens, N tokens a
    window); ``bytes``, q, k and v read and the output written in bf16 and
    the bias table read once; ``mask_bytes``, apart, the shifted blocks'
    masks in bf16 (one a block, shared by the batch), which an
    implementation that forms the mask from the tokens' positions need not
    read."""
    fl = nbytes = mask = 0.0
    for i, (res, ws, ss) in enumerate(ref.stage_windows(cfg, spatial)):
        c, heads = cfg["feature_size"] * 2 ** i, cfg["num_heads"][i]
        tokens = math.prod(-(-r // w) * w for r, w in zip(res, ws))
        n = math.prod(ws)
        for j in range(cfg["depths"][i]):
            fl += 4.0 * batch * tokens * n * c
            nbytes += 2.0 * 4 * batch * tokens * c + 2.0 * (2 * cfg["window_size"] - 1) ** 3 * heads
            if j % 2 and any(ss):
                mask += 2.0 * (tokens // n) * n * n
    return {"flops": fl, "bytes": nbytes, "mask_bytes": mask}
