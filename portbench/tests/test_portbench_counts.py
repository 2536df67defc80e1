"""The work counts against closed forms."""

import math

import pytest

from portbench.nets import unet
from portbench.reference import unet as ref_unet

CFGS = {
    "unet3d_d4f16": dict(ndim=3, depth=4, top_filter=16, midchannels_factor=1, norm="group",
                         in_channels=1, out_channels=1),
    "unet2d_d5f32": dict(ndim=2, depth=5, top_filter=32, midchannels_factor=1, norm="batch",
                         in_channels=1, out_channels=1),
    "unet2d_d3f8_mcf2": dict(ndim=2, depth=3, top_filter=8, midchannels_factor=2, norm="batch",
                             in_channels=1, out_channels=1),
}


def closed_form(cfg, batch, spatial):
    """(forward FLOPs, FLOPs of the first conv): 2 multiply-adds per tap of
    every conv output, a transposed conv's per tap of its input."""
    nd = cfg["ndim"]
    total, first = 0, None
    for name, shape in ref_unet.param_shapes(cfg).items():
        if not name.endswith(".weight") or ".bn" in name:
            continue
        if name.startswith("up_samp"):
            level = cfg["depth"] - 1 - int(name.split(".")[1])
            taps = shape[0] * shape[1] * 2 ** nd
            positions = math.prod(s // 2 ** level for s in spatial)
        else:
            block = name.split(".")[0]
            level = (cfg["depth"] - 1 if block == "bottleneck_block"
                     else 0 if block == "final_conv"
                     else int(name.split(".")[1]) if block == "down_block"
                     else cfg["depth"] - 2 - int(name.split(".")[1]))
            taps = math.prod(shape)
            positions = math.prod(s // 2 ** level for s in spatial)
        flops = 2 * batch * taps * positions
        first = flops if first is None else first
        total += flops
    return total, first


@pytest.mark.parametrize("name", sorted(CFGS))
def test_net_flops_match_the_closed_form(name):
    cfg = CFGS[name]
    spatial = (32,) * cfg["ndim"]
    fwd, first = closed_form(cfg, 2, spatial)
    assert unet.flops(cfg, 2, spatial, train=False) == fwd
    # backward: each conv's weight gradient and its input's gradient cost
    # what its forward does, but the image needs no gradient
    assert unet.flops(cfg, 2, spatial, train=True) == fwd + fwd + (fwd - first)


def test_headline_counts():
    assert unet.flops(CFGS["unet3d_d4f16"], 1, (64, 64, 64), train=False) == 28_110_225_408


def test_dropout_bytes_read_and_write_each_level_twice():
    cfg = CFGS["unet2d_d5f32"]
    per_sample = sum(32 * 2 ** lv * (256 // 2 ** lv) ** 2 for lv in range(5))
    assert unet.dropout_bytes(cfg, 128, (256, 256)) == 16 * 128 * per_sample
