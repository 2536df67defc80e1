"""Swin UNETR (``ich_tpu_torch/models/swin_unetr.py``) against the plain
reference (``portbench/reference/swin_unetr.py``) on seeded weights at a
small size on the CPU (32^3 patches, 12 features: stage resolutions 16
and 8 padded to the 7^3 window and shifted, 4 and 2 clamped), its pieces
against their definitions, planted faults, and the net served through
``UNet3D.segment_volume`` on the sliding window's general route."""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ich_tpu_torch.models import swin_unetr as sw
from ich_tpu_torch.ops import sliding_window
from ich_tpu_torch.train.segmentation3d import UNet3D
from portbench.common.weights import load_into
from portbench.nets import swin_unetr as net_mod
from portbench.reference import sliding_window as ref_sw
from portbench.reference import swin_unetr as ref

CFG = {"in_channels": 1, "out_channels": 1, "feature_size": 12, "depths": [2, 2, 2, 2],
       "num_heads": [3, 6, 12, 24], "window_size": 7, "patch_size": 2, "mlp_ratio": 4,
       "compute_dtype": "float32"}
# The largest logit gap over the largest logit. Both sides compute in
# float32 and differ only in the order of their sums (the port's batched
# window products and ATen's InstanceNorm against the reference's window
# loop and explicit statistics): they read 1.7e-6. The bound is some ten
# times that; the faults below read 6e-4 (the bias table, whose entries
# have std 0.02) to 7e-2.
TOL = 2e-5


def _net_and_weights(seed=3):
    w = net_mod.make_weights(CFG, torch.Generator().manual_seed(seed), "cpu")
    net = net_mod.build(CFG, "cpu", torch.float32)
    load_into(net, w)
    net.use_final_activation = False
    return net.eval(), w


@pytest.fixture(scope="module")
def pair():
    net, w = _net_and_weights()
    x = torch.rand(2, 1, 32, 32, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = ref.forward(w, x, CFG, logits=True)
    return net, x, want


def _gap(net, x, want):
    with torch.no_grad():
        return float((net(x) - want).abs().max() / want.abs().max())


def test_the_port_holds_the_reference(pair):
    net, x, want = pair
    assert _gap(net, x, want) < TOL


@pytest.mark.parametrize("shape,ws", [((2, 14, 14, 14, 3), (7, 7, 7)),
                                      ((1, 4, 14, 7, 5), (4, 7, 7)),
                                      ((3, 2, 2, 2, 4), (2, 2, 2))])
def test_window_partition_round_trip(shape, ws):
    x = torch.randn(shape)
    win = sw.window_partition(x, ws)
    assert win.shape == (x.numel() // (np.prod(ws) * shape[-1]), np.prod(ws), shape[-1])
    # the first window holds the first ws block of the first sample
    assert torch.equal(win[0], x[0, :ws[0], :ws[1], :ws[2]].reshape(-1, shape[-1]))
    assert torch.equal(sw.window_reverse(win, ws, shape[1:4]), x)


@pytest.mark.parametrize("dims", [(21, 21, 21), (14, 14, 14), (14, 21, 7)])
def test_shift_mask_follows_the_27_regions(dims):
    ws, ss = (7, 7, 7), (3, 3, 3)
    mask = sw.shift_mask(dims, ws, ss, torch.device("cpu"), torch.float32)

    def region(c, n):
        return 0 if c < n - 7 else 1 if c < n - 3 else 2

    label = np.array([[[9 * region(z, dims[0]) + 3 * region(y, dims[1]) + region(x, dims[2])
                        for x in range(dims[2])] for y in range(dims[1])]
                      for z in range(dims[0])])
    want = []
    for z0, y0, x0 in itertools.product(*[range(0, n, 7) for n in dims]):
        lab = label[z0:z0 + 7, y0:y0 + 7, x0:x0 + 7].reshape(-1)
        want.append(np.where(lab[:, None] == lab[None, :], 0.0, -100.0))
    assert np.array_equal(mask.numpy(), np.stack(want))


@pytest.mark.parametrize("ws", [(7, 7, 7), (4, 4, 4), (2, 7, 3)])
def test_relative_index_table(ws):
    idx = sw.relative_position_index(ws, 7, torch.device("cpu"))
    pos = list(itertools.product(*[range(n) for n in ws]))
    for i, j in [(0, 0), (0, len(pos) - 1), (len(pos) - 1, 0), (len(pos) // 2, 1)]:
        d = [a - b for a, b in zip(pos[i], pos[j])]
        assert int(idx[i, j]) == (d[0] + 6) * 169 + (d[1] + 6) * 13 + (d[2] + 6)
    assert int(idx.min()) >= 0 and int(idx.max()) < 13 ** 3


@pytest.mark.parametrize("res,window,shift", [((64, 64, 64), (7, 7, 7), (3, 3, 3)),
                                              ((8, 8, 8), (7, 7, 7), (3, 3, 3)),
                                              ((7, 7, 7), (7, 7, 7), (0, 0, 0)),
                                              ((4, 16, 2), (4, 7, 2), (0, 3, 0))])
def test_window_and_shift_clamp(res, window, shift):
    assert sw.window_and_shift(res, 7, 3) == (window, shift)


def test_merging_takes_the_eight_distinct_neighbours():
    x = torch.arange(4 * 4 * 4, dtype=torch.float32).view(1, 4, 4, 4, 1)
    out = sw.merge_neighbours(x)
    assert out.shape == (1, 2, 2, 2, 8)
    want = [x[0, i, j, k, 0] for i, j, k in itertools.product(range(2), repeat=3)]
    assert torch.equal(out[0, 0, 0, 0], torch.stack(want))
    assert len(set(out.reshape(-1).tolist())) == 64


def _no_shift_mask(monkeypatch):
    monkeypatch.setattr(sw, "shift_mask", lambda *a: None)


def _no_bias(monkeypatch, net):
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, sw.WindowAttention):
                m.relative_position_bias_table.zero_()


def _padding_masked(monkeypatch):
    forward = sw.WindowAttention.forward

    def masked(self, x, ws, mask):
        pad = (x == 0).all(-1)  # padded tokens are zeros after LN1
        m = torch.where(pad[:, None, :], -100.0, 0.0).expand(-1, x.shape[1], -1)
        if mask is not None:
            m = m + mask.repeat(x.shape[0] // mask.shape[0], 1, 1)
        return forward(self, x, ws, m)

    monkeypatch.setattr(sw.WindowAttention, "forward", masked)


def _roll_kept(monkeypatch):
    roll = torch.roll
    monkeypatch.setattr(torch, "roll", lambda t, shifts, dims: (
        roll(t, shifts, dims) if shifts[0] < 0 else t))


def _relu(monkeypatch):
    relu = F.relu
    monkeypatch.setattr(F, "leaky_relu", lambda t, slope=0.01: relu(t))


FAULTS = {"shift_mask_dropped": _no_shift_mask, "bias_dropped": _no_bias,
          "padding_masked": _padding_masked, "roll_not_reversed": _roll_kept,
          "relu_for_leaky_relu": _relu}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_leaves_the_tolerance(monkeypatch, pair, fault):
    _, x, want = pair
    net, _ = _net_and_weights()
    plant = FAULTS[fault]
    plant(monkeypatch, net) if fault == "bias_dropped" else plant(monkeypatch)
    assert _gap(net, x, want) > TOL


def test_segment_volume_on_the_general_route(monkeypatch):
    """Patch 32^3 at overlap 0.6 (stride 12, which does not divide 32) over
    32 x 60 x 60: the general route, its last start clamped to 28."""
    net, w = _net_and_weights(seed=11)
    net.use_final_activation = True
    calls = []
    general = sliding_window._sliding_window_general
    monkeypatch.setattr(sliding_window, "_sliding_window_general",
                        lambda *a, **k: calls.append(1) or general(*a, **k))
    vol = (torch.rand(32, 60, 60, generator=torch.Generator().manual_seed(7)) * 300 - 50)
    trainer = UNet3D(net, patch_size=(32, 32, 32), sw_overlap=0.6, sw_batch_size=4,
                     device="cpu")
    mask = trainer.segment_volume(vol.numpy(), window=(50, 200))
    assert calls
    with torch.no_grad():
        p = ref_sw.probabilities(lambda x: ref.forward(w, x, CFG), vol, (32, 32, 32), 0.6,
                                 (50, 200))
    assert mask.shape == p.shape and set(np.unique(mask)) <= {0, 255}
    sure = (p - 0.5).abs() > 1e-4
    assert bool(sure.float().mean() > 0.99)
    assert np.array_equal(mask[sure.numpy()] == 255, (p[sure] >= 0.5).numpy())
