"""The Swin UNETR cell ``serve3d_swin_p128``: a whole run at its tiny cut
on the CPU comes out correct, and not correct with the served mask
altered where it is produced; the FLOPs counted over its reference equal
the closed form from its shapes, of which the attention cores' part is
``attention_work``'s."""

import math
import time

from portbench.common import manifest
from portbench.nets import swin_unetr
from portbench.reference import swin_unetr as ref
from portbench.run import measure
from portbench.tests.test_portbench_run import _altered
from portbench.tests.tiny import tiny_cell

BENCH = manifest.benchmark()
SEED = 2**31 + 4321
CELL = "serve3d_swin_p128"


def run():
    return measure(tiny_cell(CELL), SEED, 0.5, False, "cpu", time.time(), BENCH)


def test_a_tiny_run_comes_out_correct():
    r = run()
    assert r["correct"], r["checks"]


def test_an_altered_mask_comes_out_not_correct(monkeypatch):
    _altered(monkeypatch)
    assert not run()["correct"]


def closed_form(cfg, spatial):
    """Forward FLOPs of one patch: 2 per multiply-add of every conv and
    linear (qkv and the projection over the padded windows' tokens), and
    the attention cores'."""
    f, ps = cfg["feature_size"], cfg["patch_size"]
    shapes = ref.param_shapes(cfg)
    res0 = [s // ps for s in spatial]
    total = 2 * math.prod(shapes["swin.patch_embed.weight"]) * math.prod(res0)
    for i, (res, ws, _) in enumerate(ref.stage_windows(cfg, spatial)):
        c = f * 2 ** i
        tokens = math.prod(res)
        padded = math.prod(-(-r // w) * w for r, w in zip(res, ws))
        per_block = 2 * padded * (3 * c * c + c * c) + 2 * tokens * 2 * c * 4 * c
        total += cfg["depths"][i] * per_block
        total += 2 * math.prod(-(-r // 2) for r in res) * 8 * c * 2 * c
    total += swin_unetr.attention_work(cfg, 1, spatial)["flops"]
    levels = {"encoder1": 0, "encoder2": 1, "encoder3": 2, "encoder4": 3, "encoder10": 5,
              "decoder5": 4, "decoder4": 3, "decoder3": 2, "decoder2": 1, "decoder1": 0}
    for name, shape in shapes.items():
        block = name.split(".")[0]
        if block not in levels:
            continue
        level = levels[block]
        positions = math.prod(s // 2 ** level for s in spatial)
        if name.endswith(".up.weight"):  # per tap of its input, a level below
            total += 2 * math.prod(shape) * positions // 8
        else:
            total += 2 * math.prod(shape) * positions
    total += 2 * math.prod(shapes["out.weight"]) * math.prod(spatial)
    return total


def test_flops_match_the_closed_form():
    cfg = manifest.cell(CELL)["config_data"]["net"]
    spatial = tuple(manifest.cell(CELL)["config_data"]["inference"]["patch_size"])
    assert swin_unetr.flops(cfg, 1, spatial, train=False) == closed_form(cfg, spatial)


def test_attention_work_at_128():
    cfg = manifest.cell(CELL)["config_data"]["net"]
    w = swin_unetr.attention_work(cfg, 1, (128, 128, 128))
    # padded tokens 70^3, 35^3, 21^3, 14^3 at widths 48, 96, 192, 384, two
    # blocks a stage, 343 tokens a window
    tokens_c = 70 ** 3 * 48 + 35 ** 3 * 96 + 21 ** 3 * 192 + 14 ** 3 * 384
    assert w["flops"] == 2 * 4 * 343 * tokens_c
    masks = sum((n // 7) ** 3 * 343 * 343 for n in (70, 35, 21, 14))
    tables = 2 * 13 ** 3 * (3 + 6 + 12 + 24)
    assert w["bytes"] == 2 * (2 * 4 * tokens_c) + 2 * tables
    assert w["mask_bytes"] == 2 * masks
    w4 = swin_unetr.attention_work(cfg, 4, (128,) * 3)
    assert w4["bytes"] == 4 * 2 * (2 * 4 * tokens_c) + 2 * tables
    assert w4["mask_bytes"] == 2 * masks
