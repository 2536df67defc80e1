"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: the result line's shape, and ``correct`` coming out
false with the timed path broken underneath, once for each fault the
cell can have (a step that leaves the state as it was, half of the batch
left out with the mean over the rest, an answer altered where it is
produced), and for faults of the window's steps alone (half of the batch
left out once set-up is done, the schedule's decay dropped)."""

import time

import pytest
import torch

from portbench.common import manifest
from portbench.run import checks_of, is_correct, measure
from portbench.tests.tiny import SETUP_STEPS, tiny_cell

BENCH = manifest.benchmark()
SEED = 2**31 + 99


def run(cell_name, trace=False, seconds=0.5):
    return measure(tiny_cell(cell_name), SEED, seconds, trace, "cpu", time.time(), BENCH)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_run_prints_the_contracts_line(cell):
    r = run(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(manifest.cell(cell)["limits"])


def test_a_traced_run_carries_the_breakdown():
    r = run("serve3d_p64", trace=True)
    assert list(r)[-2:] == ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def _unchanged(monkeypatch):
    from ich_tpu_torch.train import segmentation2d

    monkeypatch.setattr(segmentation2d, "make_schedule", lambda *a, **k: (lambda step: 0.0))


def _half_batch(monkeypatch, from_step=0):
    from ich_tpu_torch.train.segmentation2d import UNet2D

    update = UNet2D._update

    def half(self, state, images, masks, augment, drop_key):
        if state.step < from_step:
            return update(self, state, images, masks, augment, drop_key)
        b = images.shape[0] // 2
        return update(self, state, images[:b], masks[:b], augment, drop_key)

    monkeypatch.setattr(UNet2D, "_update", half)


def _window_half_batch(monkeypatch):
    _half_batch(monkeypatch, from_step=SETUP_STEPS)


def _schedule_dropped(monkeypatch):
    from ich_tpu_torch.train import segmentation2d

    monkeypatch.setattr(segmentation2d, "make_schedule", lambda name, lr, *a, **k: (lambda step: lr))


def _altered(monkeypatch):
    from ich_tpu_torch.train.segmentation2d import UNet2D

    finish = UNet2D._finish

    def altered(self, mask, affine, save_fn):
        pred = finish(self, mask, affine, save_fn).copy()
        pred.reshape(-1)[::4099] ^= 255
        return pred

    monkeypatch.setattr(UNet2D, "_finish", altered)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered,
          "window_half_batch": _window_half_batch, "schedule_dropped": _schedule_dropped}
CASES = [(cell, fault) for cell in ("train2d_bs128", "train3d_p64_bs64")
         for fault in ("unchanged", "half_batch", "window_half_batch", "schedule_dropped")]
CASES.append(("serve3d_p64", "altered"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_underneath_comes_out_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    assert not run(cell)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_comes_out_not_correct_on_the_card(cell):
    """At the cell's own size: the control's readings, held to the cell's
    limits, fail at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = manifest.cell(cell)
    d = manifest.driver(c).Driver(c, SEED, "cuda")
    win = d.window(3.0)
    d.free()
    readings = d.control()
    compared = {k: v for k, v in c["limits"].items() if k in readings}
    assert not is_correct(win["attempted"], win["failed"], checks_of(readings, compared)), \
        readings
