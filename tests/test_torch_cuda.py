"""Tests of the port that need an NVIDIA card (marker ``cuda``). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test here skips."""

import numpy as np
import pytest
import torch

from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import edt
from ich_tpu_torch.train.segmentation2d import UNet2D

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("rows,n", [(4096, 256), (2048, 512), (13, 100), (3, 4096)])
def test_kernel_matches_plain_on_card(card, rows, n):
    rng = np.random.default_rng(rows + n)
    g = np.where(rng.uniform(size=(rows, n)) < 0.1, 0.0, edt.INF).astype(np.float32)
    g = torch.from_numpy(g).cuda()
    before = edt.launches
    got = edt.edt_pass_1d(g)
    torch.cuda.synchronize()
    assert edt.launches == before + 1
    assert torch.equal(got, edt.edt_pass_1d_plain(g))
    assert torch.equal(edt.edt_pass_1d(got), edt.edt_pass_1d_plain(got))


def test_kernel_rejects_non_contiguous(card):
    with pytest.raises(ValueError):
        edt.edt_pass_1d(torch.zeros(8, 16, device="cuda").t())


def test_segment_volume_card_matches_cpu(card):
    torch.manual_seed(0)
    net = UNet(depth=3, top_filter=8, p_dropout=0.0)
    rng = np.random.default_rng(0)
    vol = rng.uniform(-50, 150, size=(48, 40, 7)).astype(np.float32)
    cpu = UNet2D(net, batch_size=4, device="cpu")
    want = cpu.segment_volume(vol, window=(50, 200), input_size=(32, 32), return_pred=True)
    gpu = UNet2D(net, batch_size=4, device="cuda")
    got = gpu.segment_volume(vol, window=(50, 200), input_size=(32, 32), return_pred=True)
    assert got.shape == vol.shape
    assert np.mean(got == want) >= 0.999
