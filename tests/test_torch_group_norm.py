"""``ops/group_norm.py`` on the CPU: the plain version, the autograd
function's CPU path and the ``ConvBlock`` that calls it. The kernels run on
the card only (``tests/test_torch_cuda.py``).

Tolerances: the forward bit for bit (the CPU path is torch's own
``group_norm`` and ``relu``); float32 gradients within 1e-5 of the largest
element of autograd's through ``F.relu(F.group_norm)``: the same function,
its sums taken in another order (the readings are some 2e-7)."""

import pytest
import torch
import torch.nn.functional as F

from ich_tpu_torch.models import layers
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import group_norm as gn

torch.set_num_threads(2)

EPS = 1e-6
# (shape, groups): the 3D net's levels (16 channels a group, 1-8 groups),
# at rank 5 and rank 4
CASES = [((2, 16, 8, 6, 4), 1), ((3, 32, 4, 4, 5), 2), ((2, 64, 3, 4, 4), 4),
         ((2, 128, 2, 3, 3), 8), ((2, 16, 9, 7), 1), ((3, 32, 5, 4), 2), ((2, 64, 4, 3), 4),
         ((2, 128, 3, 3), 8)]


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    w = torch.rand(shape[1], generator=g) + 0.5
    b = torch.randn(shape[1], generator=g) * 0.3
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", CASES)
def test_plain_and_wrapper_equal_relu_of_group_norm(shape, groups, dtype):
    x, w, b = _inputs(shape, dtype)
    want = F.relu(F.group_norm(x, groups, w.to(dtype), b.to(dtype), EPS))
    assert torch.equal(gn.group_norm_relu_plain(x, groups, w, b, EPS), want)
    assert torch.equal(gn.group_norm_relu(x, groups, w, b, EPS), want)
    got = gn.group_norm_relu(x.requires_grad_(), groups, w, b, EPS)
    assert got.grad_fn.name() == "_GroupNormReLUBackward"
    assert got.dtype == dtype and torch.equal(got.detach(), want)


@pytest.mark.parametrize("shape,groups", CASES)
def test_gradients_match_autograd_through_relu_of_group_norm(shape, groups):
    x, w, b = _inputs(shape, torch.float32, seed=1)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    gn.group_norm_relu(leaves[0], groups, leaves[1], leaves[2], EPS).backward(dy)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    F.relu(F.group_norm(ref[0], groups, ref[1], ref[2], EPS)).backward(dy)
    for got, want in zip(leaves, ref):
        assert got.grad.dtype == want.grad.dtype == torch.float32
        assert float((got.grad - want.grad).abs().max()) <= 1e-5 * float(want.grad.abs().max())


def test_plain_backward_recomputes_the_relu_mask():
    """Where the norm's output is negative the gradient stops: with every
    output clipped (bias far below zero) nothing flows back."""
    x, w, _ = _inputs((2, 32, 4, 4, 4), torch.float32)
    b = torch.full((32,), -100.0)
    mean, rstd = gn._stats_plain(x, 2, EPS)
    dx, dw, db = gn.group_norm_relu_backward_plain(torch.ones_like(x), x, 2, w, b, mean, rstd)
    assert not dx.any() and not dw.any() and not db.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet3d_output_unchanged_on_the_cpu(monkeypatch, dtype):
    """The 3D net's forward through the fused call equals, bit for bit, the
    same net through ``F.relu(norm(y))``, the blocks' path before it."""
    net = UNet(depth=4, ndim=3, top_filter=16, midchannels_factor=1, norm="group",
               p_dropout=0.0, dtype=dtype).eval()
    x = torch.randn((2, 1, 16, 16, 16), generator=torch.Generator().manual_seed(3))
    calls = []

    def counted(norm, y):
        calls.append(type(norm).__name__)
        return gn.group_norm_relu(y, norm.num_groups, norm.weight, norm.bias, norm.eps)

    with torch.no_grad():
        monkeypatch.setattr(layers, "norm_relu", counted)
        got = net(x)
        monkeypatch.setattr(layers, "norm_relu", lambda norm, y: F.relu(norm(y)))
        want = net(x)
    assert torch.equal(got, want)
    assert calls == ["GroupNorm"] * 14  # 7 blocks, two norms each


def test_batch_norm_block_keeps_relu_of_batch_norm(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a BatchNorm block called group_norm_relu")

    monkeypatch.setattr(layers, "group_norm_relu", refuse)
    block = layers.ConvBlock(2, 8, ndim=3, norm="batch").eval()
    with torch.no_grad():
        for m in (block.conv1, block.conv2):
            m.weight.normal_(generator=torch.Generator().manual_seed(4))
        x = torch.randn((2, 2, 6, 6, 6), generator=torch.Generator().manual_seed(5))
        want = F.relu(block.bn2(block.conv2(F.relu(block.bn1(block.conv1(x))))))
        assert torch.equal(block(x), want)


def test_group_norm_block_takes_the_fused_call(monkeypatch):
    calls = []
    fused = layers.group_norm_relu

    def counted(y, *args):
        calls.append(tuple(y.shape))
        return fused(y, *args)

    monkeypatch.setattr(layers, "group_norm_relu", counted)
    block = layers.ConvBlock(2, 32, ndim=3, norm="group", gated=True)
    block(torch.randn(1, 2, 4, 4, 4)).sum().backward()
    assert calls == [(1, 32, 4, 4, 4)] * 2
    assert block.bn1.weight.grad is not None and block.bn2.bias.grad is not None


@pytest.mark.parametrize("make,match", [
    (lambda: torch.zeros(2, 16, 4, 4, 4, dtype=torch.float16), "float32 or bfloat16"),
    (lambda: torch.zeros(2, 16, 64), "contiguous"),
    (lambda: torch.zeros(2, 16, 4, 4, 4).contiguous(memory_format=torch.channels_last_3d),
     "contiguous"),
    (lambda: torch.zeros(0, 16, 4, 4), "non-empty"),
])
def test_the_card_path_refuses_what_the_kernels_do_not_take(make, match):
    x = make()
    w = torch.ones(16)
    with pytest.raises(ValueError, match=match):
        gn._check(x, 1, w, w)
    with pytest.raises(ValueError, match="channels in"):
        gn._check(torch.zeros(2, 16, 4, 4), 3, w, w)
    with pytest.raises(ValueError, match="weight"):
        gn._check(torch.zeros(2, 16, 4, 4), 1, torch.ones(8), w)
    with pytest.raises(ValueError, match="unsupported device"):
        gn._forward(torch.zeros(2, 16, 4, 4), 1, w, w, EPS)


@pytest.mark.parametrize("s,itemsize,want", [
    (64 ** 3, 2, (8, 256, 16384, 16)),  # bf16 64^3: 16-byte loads, 16 segments a plane
    (32 ** 3, 2, (8, 256, 16384, 2)),
    (16 ** 3, 2, (8, 64, 4096, 1)),  # a short plane fills one block of fewer warps
    (8 ** 3, 2, (8, 32, 2048, 1)),
    (64 ** 3, 4, (4, 256, 8192, 32)),  # float32
    (64 * 128 * 128, 4, (4, 256, 32768, 32)),  # a long plane: longer segments, at most 32
    (7 * 9 * 11, 2, (1, 96, 768, 1)),  # not a multiple of the vector: one element a load
])
def test_segments_follow_the_plane(s, itemsize, want):
    assert gn._geometry(s, itemsize) == want
