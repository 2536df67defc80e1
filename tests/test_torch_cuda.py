"""Tests of the port that need an NVIDIA card (marker ``cuda``). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test here skips."""

import numpy as np
import pytest
import torch

from ich_tpu_torch.data.core import LabeledSliceDataset, VolumeDataset3D
from ich_tpu_torch.data.patch_sampler import DevicePatchSampler
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, synthetic_rsna_slices
from ich_tpu_torch.models.resnet import resnet18
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder
from ich_tpu_torch.models.layers import set_dropout_keys
from ich_tpu_torch.ops import dropout, edt
from ich_tpu_torch.ops import group_norm as gn
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops import transforms3d as T3
from ich_tpu_torch.train.classifier import BinaryClassifier, MultiClassifier
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.train.segmentation3d import UNet3D
from ich_tpu_torch.train.ssl import ContextRestoration, Contrastive
from ich_tpu_torch.utils import rng as prng

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


@pytest.mark.parametrize("rows,n", [(64, 4096), (13, 100)])
def test_kernel_matches_plain_on_card_integer_costs(card, rows, n):
    """General costs in the kernel's exact domain (integers below 2^34)."""
    rng = np.random.default_rng(rows * n)
    g = torch.from_numpy(rng.integers(0, 1 << 24, size=(rows, n)).astype(np.float32)).cuda()
    assert torch.equal(edt.edt_pass_1d(g), edt.edt_pass_1d_plain(g))


@pytest.mark.parametrize("shape", [(16, 256, 256), (3, 100, 37), (2, 1, 5, 64)])
def test_transform_kernel_matches_plain_on_card(card, shape):
    rng = np.random.default_rng(sum(shape))
    mask = (rng.uniform(size=shape) > 0.05).astype(np.float32)
    flat = mask.reshape((-1,) + shape[-2:])
    flat[0], flat[-1, 0] = 1.0, 0.0  # an image without a site; a row of sites
    m = torch.from_numpy(mask).cuda()
    before = (edt.launches, edt.mask_launches)
    got = edt.distance_transform_edt_kernel(m)
    torch.cuda.synchronize()
    assert (edt.launches, edt.mask_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == m.shape
    assert torch.equal(got, edt.distance_transform_edt_plain(m))
    assert bool((got.reshape(flat.shape)[0] == 1e5).all())


def test_kernels_reject_long_lines_before_launch(card):
    before = (edt.launches, edt.mask_launches)
    with pytest.raises(ValueError):
        edt.edt_pass_1d(torch.zeros(2, 4097, device="cuda"))
    with pytest.raises(ValueError):
        edt.distance_transform_edt_kernel(torch.ones(1, 4097, 8, device="cuda"))
    with pytest.raises(ValueError):
        edt.distance_transform_edt_kernel(torch.ones(1, 8, 4097, device="cuda"))
    assert (edt.launches, edt.mask_launches) == before


def test_kernel_rejects_non_contiguous(card):
    with pytest.raises(ValueError):
        edt.edt_pass_1d(torch.zeros(8, 16, device="cuda").t())


# the five shapes of configs/unet2d.json's dropout at batch 4 (C, H, W),
# a ragged shape, and the 3D net's bf16 layout
DROPOUT_SHAPES = [(4, 32, 256, 256), (4, 64, 128, 128), (4, 128, 64, 64), (4, 256, 32, 32),
                  (4, 512, 16, 16), (3, 5, 7, 9), (2, 16, 8, 16, 16)]


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("offset", [0, 4, 6])
@pytest.mark.parametrize("shape", DROPOUT_SHAPES)
def test_keyed_dropout_kernel_matches_plain_on_card(card, shape, offset, channels_last):
    """The kernel ``torch.equal`` to its plain version on the same tensor
    in NCHW and channels-last storage (float32; bf16 for the 5-D shape),
    one launch each, at offsets that start mid-block."""
    dtype = torch.bfloat16 if len(shape) == 5 else torch.float32
    x = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(shape)
                         .astype(np.float32)).to("cuda", dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last if x.dim() == 4
                         else torch.channels_last_3d)
    key = (*prng.prng_key(offset + 1).tolist(), 0x9E3779B9)
    for rate in (0.5, 0.1):
        before = dropout.launches
        got = dropout.keyed_dropout(x, key, rate, offset)
        torch.cuda.synchronize()
        assert dropout.launches == before + 1
        assert got.stride() == x.stride()
        assert torch.equal(got, dropout.keyed_dropout_plain(x, key, rate, offset))


def test_keyed_dropout_backward_on_card(card):
    """The gradient is the kernel on the gradient: the same mask, ``g /
    keep``; a second launch, no saved mask."""
    x = torch.randn(2, 8, 16, 16, device="cuda", requires_grad=True)
    g = torch.randn(2, 8, 16, 16, device="cuda")
    key = (*prng.prng_key(5).tolist(), 7)
    before = dropout.launches
    y = dropout.keyed_dropout(x, key, 0.3)
    y.backward(g)
    torch.cuda.synchronize()
    assert dropout.launches == before + 2
    assert torch.equal(x.grad, dropout.keyed_dropout_plain(g, key, 0.3))
    assert torch.equal(x.grad != 0, y != 0)


# (N, C, *spatial, groups): the 3D net's four GroupNorm shapes (depth 4, top
# filter 16: 16 channels a group at every level) in a serve call of 128
# patches and a training step of 64, the serve's second call of 97; rows
# far under the card's 132 SMs (2 and 6); a plane whose length is no
# multiple of the 16-byte vector; a rank-4 tensor
GN_SHAPES = [(128, 16, 64, 64, 64, 1), (128, 32, 32, 32, 32, 2), (128, 64, 16, 16, 16, 4),
             (128, 128, 8, 8, 8, 8), (97, 16, 64, 64, 64, 1), (64, 16, 64, 64, 64, 1),
             (64, 32, 32, 32, 32, 2), (64, 64, 16, 16, 16, 4), (64, 128, 8, 8, 8, 8),
             (2, 16, 64, 64, 64, 1), (2, 48, 7, 9, 11, 3), (4, 32, 24, 20, 2)]


def _gn_inputs(shape, dtype):
    *dims, groups = shape
    g = torch.Generator(device="cuda").manual_seed(sum(dims))
    x = (torch.randn(dims, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    w = torch.rand(dims[1], device="cuda", generator=g) + 0.5
    b = torch.randn(dims[1], device="cuda", generator=g) * 0.3
    dy = torch.randn(dims, device="cuda", generator=g).to(dtype)
    return x, groups, w, b, dy


def _within_bf16_ulp(got, want_f32, atol):
    """Each bf16 element within one bf16 ulp of the float32 value, or
    within ``atol`` of it (near zero, where bf16's ulps are finer than the
    float32 sums' own spread)."""
    ulp = torch.ldexp(torch.ones_like(want_f32), torch.frexp(want_f32).exponent - 8)
    err = (got.to(torch.float32) - want_f32).abs()
    return bool(((err <= ulp) | (err <= atol)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_relu_kernels_match_plain_on_card(card, shape, dtype):
    """Forward and backward kernels against the plain versions on the card,
    two launches each. bf16: the output and dx each within one bf16 ulp of
    the plain version computed in float32, or within 1e-5 of the largest
    element near zero (the order of the float32 sums moves the value by
    some 1e-7 of the largest); float32: within 1e-5 of the largest. The
    backward's plain version takes the kernels' statistics, so its mask is
    theirs; dweight and dbias, sums over N x S elements, within 1e-4 of the
    largest. The statistics within 1e-6 (mean, of the inputs' scale) and
    1e-5 (rstd, relative) of the plain ones."""
    x, groups, w, b, dy = _gn_inputs(shape, dtype)
    before = gn.launches
    y, mean, rstd = gn._forward(x, groups, w, b, 1e-6)
    dx, dw, db = gn._backward(dy, x, groups, w, b, mean, rstd)
    torch.cuda.synchronize()
    assert gn.launches == before + 4
    m, r = gn._stats_plain(x, groups, 1e-6)
    assert float((mean - m).abs().max()) <= 1e-6 * float(x.float().abs().max())
    assert float(((rstd - r) / r).abs().max()) <= 1e-5
    _hold_to_plain(x, groups, w, b, dy, mean, rstd, y, dx, dw, db)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_SHAPES[:9])
def test_group_norm_relu_entry_matches_plain_on_card(card, shape, dtype):
    """The nets' entry, ``group_norm_relu`` on leaves that want gradients,
    its backward through autograd, at the serve's and the training step's
    shapes: the output and the gradients of ``x``, ``weight`` and ``bias``
    held to the plain versions at the kernels' tolerances above, the
    plain backward taking the statistics of a direct forward launch (the
    kernels sum in a fixed order, so they are the entry's own)."""
    x, groups, w, b, dy = _gn_inputs(shape, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = gn.launches
    y = gn.group_norm_relu(leaves[0], groups, leaves[1], leaves[2], 1e-6)
    y.backward(dy)
    torch.cuda.synchronize()
    assert gn.launches == before + 4
    assert "GroupNormReLUBackward" in y.grad_fn.name()
    _, mean, rstd = gn._forward(x, groups, w, b, 1e-6)
    _hold_to_plain(x, groups, w, b, dy, mean, rstd, y.detach(),
                   *(t.grad for t in leaves))


def _hold_to_plain(x, groups, w, b, dy, mean, rstd, y, dx, dw, db):
    wr, br = w.to(x.dtype).float(), b.to(x.dtype).float()  # as the kernels take them
    want = gn.group_norm_relu_plain(x.float(), groups, wr, br, 1e-6)
    tol = 1e-5 * float(want.abs().max())
    if x.dtype == torch.bfloat16:
        assert _within_bf16_ulp(y, want, tol)
    else:
        assert float((y - want).abs().max()) <= tol
    pdx, pdw, pdb = gn.group_norm_relu_backward_plain(dy.float(), x.float(), groups, wr, br,
                                                      mean, rstd)
    tol = 1e-5 * float(pdx.abs().max())
    assert dx.dtype == x.dtype
    if x.dtype == torch.bfloat16:
        assert _within_bf16_ulp(dx, pdx, tol)
    else:
        assert float((dx - pdx).abs().max()) <= tol
    for got, ref in ((dw, pdw), (db, pdb)):
        assert got.dtype == torch.float32
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_group_norm_relu_misaligned_tensor_on_card(card):
    """A contiguous view one element into its storage takes the
    one-element loads and matches the aligned tensor's result."""
    x, groups, w, b, dy = _gn_inputs((2, 32, 8, 8, 8, 2), torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(gn.group_norm_relu(shifted, groups, w, b, 1e-6),
                       gn.group_norm_relu(x, groups, w, b, 1e-6))


def test_group_norm_relu_launches_a_net_forward_and_backward(card):
    """The 3D net (depth 4, top filter 16, GroupNorm, bf16): 14 GroupNorms a
    forward, 2 launches each, and as many in its backward; a BatchNorm
    net launches none."""
    x = torch.randn(2, 1, 32, 32, 32, device="cuda")
    for norm, per_pass in (("group", 28), ("batch", 0)):
        net = UNet(depth=4, ndim=3, top_filter=16, midchannels_factor=1, norm=norm,
                   p_dropout=0.0, dtype=torch.bfloat16).cuda()
        before = gn.launches
        with torch.no_grad():
            net(x)
        assert gn.launches == before + per_pass
        net(x).float().mean().backward()
        torch.cuda.synchronize()
        assert gn.launches == before + 3 * per_pass


def test_group_norm_relu_refuses_on_card(card):
    w = torch.ones(16, device="cuda")
    for x in (torch.zeros(2, 16, 4, 4, 4, device="cuda", dtype=torch.float16),
              torch.zeros(2, 16, 4, 4, 4, device="cuda").contiguous(
                  memory_format=torch.channels_last_3d),
              torch.zeros(2, 16, 64, device="cuda")):
        with pytest.raises(ValueError):
            gn.group_norm_relu(x, 1, w, w)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_volume_3d_card_matches_cpu(card, dtype):
    """The 3D sliding-window path (d3 f8 GroupNorm, 16^3 patches) on the
    card against the CPU at 32^3: float32 (TF32 off) agrees on >= 99.9% of
    voxels, bf16 on >= 99%."""
    torch.manual_seed(0)
    net = UNet(depth=3, ndim=3, top_filter=8, norm="group", p_dropout=0.0, dtype=dtype)
    vol = np.random.default_rng(1).uniform(-50, 150, size=(32, 32, 32)).astype(np.float32)
    kw = dict(window=(50, 200))
    want = UNet3D(net, patch_size=(16, 16, 16), device="cpu").segment_volume(vol, **kw)
    got = UNet3D(net, patch_size=(16, 16, 16), device="cuda").segment_volume(vol, **kw)
    assert got.shape == vol.shape and got.dtype == np.uint8
    assert np.mean(got == want) >= (0.999 if dtype == torch.float32 else 0.99)


def test_augment_warp_card_matches_cpu(card):
    """The config's Compose with one set of (m, o) drawn on the CPU and
    injected: masks equal, images within 1e-5."""
    spec = {"Translate": {}, "Rotate": {}, "Scale": {}, "HFlip": {}}
    params = [t.affine_params(k, 16, (64, 64))
              for k, t in zip(prng.split(prng.prng_key(0), 4), T.build_pipeline(spec).transforms)]

    def injected():
        pipe = T.build_pipeline(spec)
        for t, (m, o) in zip(pipe.transforms, params):
            t.affine_params = lambda key, b, hw, m=m, o=o: (m, o)
        return pipe

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(size=(16, 64, 64)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(16, 64, 64)) > 0.7).astype(np.float32))
    want = injected()(prng.prng_key(0), img, mask)
    got = injected()(prng.prng_key(0), img.cuda(), mask.cuda())
    assert torch.equal(got[1].cpu(), want[1])
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-5


def test_train_steps_card_match_cpu(card):
    """Two train steps (d3 f8, 16 slices at 32^2, batch 8, dropout and
    augmentation off, TF32 off) from the same weights: epoch loss within
    rtol 1e-4; 99% of the weights within 1e-4 (Adam's first step is about
    lr * sign(g), so weights with a rounding-noise gradient, such as the
    biases of convs feeding a BatchNorm, may differ by up to 2 lr)."""
    ds = synthetic_ich_slices(n_slices=16, size=32, n_volumes=2, seed=0)
    torch.manual_seed(0)
    net = UNet(depth=3, top_filter=8, p_dropout=0.0)
    kw = dict(n_epoch=1, batch_size=8, lr=1e-3,
              loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2})
    cpu = UNet2D(net, device="cpu", **kw)
    want_sd = {k: v.clone() for k, v in net.state_dict().items()}
    cpu.train(ds)
    gpu = UNet2D(UNet(depth=3, top_filter=8, p_dropout=0.0), device="cuda", **kw)
    gpu.unet.load_state_dict(want_sd)
    gpu.train(ds.device_cache("cuda"))
    lc, lg = cpu.outputs["train"]["evolution"][0][1], gpu.outputs["train"]["evolution"][0][1]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    a = torch.cat([v.flatten() for v in cpu.unet.state_dict().values() if v.is_floating_point()])
    b = torch.cat([v.flatten().cpu() for v in gpu.unet.state_dict().values()
                   if v.is_floating_point()])
    d = (a - b).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.99 and float(d.max()) <= 2e-3 + 1e-6


def _volumes_3d(n=3, shape=(20, 40, 36), seed=0):
    rng = np.random.default_rng(seed)
    vols = [rng.uniform(size=shape).astype(np.float32) for _ in range(n)]
    masks = [(rng.uniform(size=shape) > 0.97).astype(np.float32) for _ in range(n)]
    return VolumeDataset3D(vols, masks, np.arange(n))


def test_patch_sampler_gather_card_matches_cpu(card):
    """The device sampler's draws from one key, its starts and gathered
    patches: equal on the card and on the CPU."""
    ds = _volumes_3d()
    out = {}
    for dev in ("cpu", "cuda"):
        s = DevicePatchSampler(ds, (16, 32, 32), pos_frac=0.5, device=dev)
        vi, start = s.starts(s.draw(prng.prng_key(1), 16))
        out[dev] = (vi.cpu(), start.cpu()) + tuple(t.cpu() for t in s.gather(vi, start))
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("order", [0, 1])
def test_warp_inplane_card_matches_cpu(card, order):
    """``AffineAugment3D``'s warp with parameters drawn from a key: masks
    (order 0) equal, images within 1e-5."""
    aug = T3.AffineAugment3D()
    m, o = aug.affine_params(prng.prng_key(0), 4)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(4, 8, 32, 40, 1))
                         .astype(np.float32))
    if order == 0:
        x = (x > 0.6).float()
    want = T3._warp_inplane(x, m, o, order)
    got = T3._warp_inplane(x.cuda(), m.cuda(), o.cuda(), order).cpu()
    if order == 0:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-5


def test_train_steps_3d_card_match_cpu(card):
    """Two 3D train steps (d3 f8 GroupNorm, 16x32x32 patches, batch 2, the
    host sampler so both devices see the same patches, TF32 off) from the
    same weights: the epoch loss within rtol 1e-4, every weight within
    Adam's bound (2 lr a step) and 99% within 1e-4."""
    ds = _volumes_3d()
    torch.manual_seed(0)
    kw = dict(patch_size=(16, 32, 32), steps_per_epoch=2, n_epoch=1, batch_size=2, lr=1e-3,
              loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2},
              on_device_sampling=False)
    net = dict(depth=3, ndim=3, top_filter=8, norm="group", p_dropout=0.0)
    cpu = UNet3D(UNet(**net), device="cpu", **kw)
    gpu = UNet3D(UNet(**net), device="cuda", **kw)
    gpu.unet.load_state_dict(cpu.unet.state_dict())
    cpu.train(ds)
    gpu.train(ds)
    lc, lg = cpu.outputs["train"]["evolution"][0][1], gpu.outputs["train"]["evolution"][0][1]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    a = torch.cat([v.flatten() for v in cpu.unet.state_dict().values()])
    b = torch.cat([v.flatten().cpu() for v in gpu.unet.state_dict().values()])
    d = (a - b).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.99 and float(d.max()) <= 4e-3 + 1e-6


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_remat_matches_plain_on_card(card, norm):
    """``remat=True`` with dropout 0.3 on the card: the recompute draws the
    same keyed dropout masks and skips BatchNorm's second running
    update, so the gradient (all parameters together: the biases of convs
    feeding a BatchNorm have rounding-noise gradients) is within rel L2 1e-5
    of the plain net's and the running statistics within rtol 1e-5 (cuDNN's
    weight gradients may sum in another order); other dropout masks would
    move the gradient by far more."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 1, 16, 32, 32))
                         .astype(np.float32)).cuda()
    nets = {}
    for remat in (False, True):
        torch.manual_seed(0)
        net = UNet(depth=3, ndim=3, top_filter=8, norm=norm, p_dropout=0.3,
                   remat=remat).cuda().train()
        set_dropout_keys(net, prng.prng_key(1))
        net(x).square().mean().backward()
        nets[remat] = net
    a, b = (torch.cat([p.grad.flatten() for p in nets[r].parameters()]) for r in (False, True))
    assert float((a - b).norm()) <= 1e-5 * float(a.norm())
    for (k, a), b in zip(nets[False].named_buffers(), nets[True].buffers()):
        assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-7), k


@pytest.mark.parametrize("rotate", [True, False])
def test_patch_swap_card_equals_cpu(card, rotate):
    """The geometry drawn on the CPU and injected: the swapped images and
    masks are equal on the card and the CPU."""
    swap = T.RandomPatchSwap(n=10, w=(10, 30), h=(10, 30), rotate=rotate)
    geom = swap.draw_geometry(prng.prng_key(0), 8, (256, 256))
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(size=(8, 256, 256, 1)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(8, 256, 256)) > 0.5).astype(np.float32))
    want = swap.apply(img, geom, mask)
    got = swap.apply(img.cuda(), tuple(g.cuda() for g in geom), mask.cuda())
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    got = swap(prng.prng_key(0), img.cuda(), mask.cuda())  # the draws on the host
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_blur_and_crop_resize_card_match_cpu(card):
    """The blur with injected flags and sigmas, and the crop-resize warp
    with injected (m, o): within 1e-5 on the card and the CPU."""
    kb, kc = prng.split(prng.prng_key(0))
    blur = T.GaussianBlur(0.5, (0.1, 2.0))
    apply, sig = blur.draw(kb, 16)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(16, 256, 256, 1)).astype(np.float32))
    want = blur.apply_params(x, apply, sig)
    got = blur.apply_params(x.cuda(), apply.cuda(), sig.cuda())
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    crop = T.RandomCropResize((0.4, 0.8))
    m, o = crop.affine_params(kc, 16, (256, 256))
    crop.affine_params = lambda key, b, hw: (m, o)
    want = crop(kc, x)
    got = crop(kc, x.cuda())
    assert float((got.cpu() - want).abs().max()) <= 1e-5


class _TwoViews:
    """The batch, then its left-right mirror, call by call."""

    def __init__(self):
        self.calls = 0

    def __call__(self, gen, x):
        self.calls += 1
        return x if self.calls % 2 else x.flip(2)


def _ssl_pair(kind):
    torch.manual_seed(0)
    small = dict(depth=3, top_filter=8, p_dropout=0.0)
    if kind == "cr":
        make = lambda: UNet(use_final_activation=False, **small)  # noqa: E731
    elif kind == "global":
        make = lambda: UNetEncoder(mlp_head=(32, 16), **small)  # noqa: E731
    else:
        make = lambda: PartialUNet(n_decoder=1, head_channel=(16, 8), **small)  # noqa: E731
    net = make()
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    out = []
    for dev, n in (("cpu", net), ("cuda", make())):
        n.load_state_dict(sd)
        kw = dict(n_epoch=1, batch_size=8, lr=1e-3, seed=0, device=dev)
        if kind == "cr":
            t = ContextRestoration(n, n_swap=3, swap_w=(4, 8), swap_h=(4, 8), **kw)
        else:
            t = Contrastive(n, is_global=kind == "global", K=2, n_region=4, **kw)
        out.append(t)
    return out


def _inject(kind, trainers, monkeypatch):
    """The same randomness on every trainer: the CPU's patch-swap geometry;
    or two fixed views and fixed region cells."""
    if kind == "cr":
        geom = trainers[0].corrupt.draw_geometry(prng.prng_key(1), 8, (32, 32))
        for t in trainers:
            swap = t.corrupt
            t.corrupt = lambda g, x, swap=swap: swap.apply(x, tuple(a.to(x.device) for a in geom))
        return
    import ich_tpu_torch.ops.losses as losses

    cells = torch.from_numpy(np.stack([np.random.default_rng(i).permutation(64)[:4]
                                       for i in range(8)]))
    monkeypatch.setattr(losses, "sample_region_cells", lambda key, b, n, r: cells)
    for t in trainers:
        t.aug = _TwoViews()


@pytest.mark.parametrize("kind", ["cr", "global", "local"])
def test_ssl_steps_card_match_cpu(card, kind, monkeypatch):
    """Each SSL trainer from the same weights (16 slices at 32^2, batch 8,
    TF32 off) with the randomness injected, on the card and the CPU. The
    first step: loss within rtol 1e-5 and gradient within 1e-3 in norm
    (two CPU thread counts differ by up to 3e-5 there). An epoch of two
    steps: loss within rtol 1e-4 and every weight within Adam's 2 lr a
    step (at fresh weights many gradients are float32 rounding, whose sign
    decides Adam's first steps)."""
    ds = synthetic_ich_slices(n_slices=16, size=32, n_volumes=2, seed=0)
    first = _ssl_pair(kind)
    _inject(kind, first, monkeypatch)
    step1 = []
    for t in first:
        state = t._train_state(2)
        t.net.train()
        loss = t._train_step(state, torch.from_numpy(ds.images[:8]).to(t.device),
                             prng.prng_key(0))
        step1.append((float(loss), torch.cat([p.grad.flatten().cpu() for p in t.net.parameters()
                                              if p.grad is not None])))
    (lc, gc), (lg, gg) = step1
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    assert float((gc - gg).norm()) <= 1e-3 * float(gc.norm())

    cpu, gpu = _ssl_pair(kind)
    _inject(kind, (cpu, gpu), monkeypatch)
    cpu.train(ds)
    gpu.train(ds.device_cache("cuda"))
    lc, lg = cpu.outputs["train"]["evolution"][0][1], gpu.outputs["train"]["evolution"][0][1]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    a = torch.cat([v.flatten() for v in cpu.net.state_dict().values() if v.is_floating_point()])
    b = torch.cat([v.flatten().cpu() for v in gpu.net.state_dict().values()
                   if v.is_floating_point()])
    assert float((a - b).abs().max()) <= 2 * 2 * 1e-3 * 1.005


def _classifier_pair(kind):
    torch.manual_seed(0)
    if kind == "resnet18":
        make, trainer = lambda: resnet18(num_classes=2), BinaryClassifier  # noqa: E731
    else:
        n_out = 7 if kind == "multi" else 2
        make = lambda: UNetEncoder(depth=3, top_filter=8, p_dropout=0.0,  # noqa: E731
                                   mlp_head=(32, n_out))
        trainer = MultiClassifier if kind == "multi" else BinaryClassifier
    net = make()
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    out = []
    for dev, n in (("cpu", net), ("cuda", make())):
        n.load_state_dict(sd)
        out.append(trainer(n, n_epoch=1, batch_size=8, lr=1e-3, seed=0, device=dev))
    return out


def _classifier_step1(kind, ds, dtype=torch.float32):
    """The step-1 loss and gradient of the CPU and the card from the same
    weights, the net (parameters and compute dtype) and the batch in
    ``dtype``."""
    out = []
    for t in _classifier_pair(kind):
        t.net.to(dtype)
        if hasattr(t.net, "dtype"):  # the U-Net casts its input to its compute dtype
            t.net.dtype = dtype
        state = t._train_state(2)
        t.net.train()
        images, labels = next(t._labelled_batches(ds, [np.arange(8)]))
        loss = t._step(state, (images.to(dtype), labels), prng.prng_key(0))
        out.append((float(loss), torch.cat([p.grad.flatten().cpu() for p in t.net.parameters()])))
    return out


@pytest.mark.parametrize("kind", ["binary", "multi", "resnet18"])
def test_classifier_steps_card_match_cpu(card, kind):
    """Each classifier from the same weights on 16 RSNA-like slices (32^2,
    64^2 for ResNet-18), batch 8, TF32 off, no augmentation, on the card
    and the CPU. The first step in float32: the loss within rtol 1e-5; in
    float64: the gradient within 1e-6 in norm (in float32 the ResNet's
    differs by 1.7%, in float64 by 5e-8: its stem's weight gradient, passed
    back through 17 BatchNorms over few values, cancels heavily). An epoch of two steps in float32:
    every weight within Adam's 2 lr a step (at fresh weights many gradients
    are float32 rounding, whose sign decides Adam's first steps). The
    scores of every slice from the same trained weights within 1e-4."""
    ds = synthetic_rsna_slices(n_slices=16, size=64 if kind == "resnet18" else 32, seed=0)
    if kind != "multi":
        ds = LabeledSliceDataset(ds.images, ds.labels[:, 0].astype(np.int32))
    (lc, _), (lg, _) = _classifier_step1(kind, ds)
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    (_, gc), (_, gg) = _classifier_step1(kind, ds, torch.float64)
    assert float((gc - gg).norm()) <= 1e-6 * float(gc.norm())

    cpu, gpu = _classifier_pair(kind)
    cpu.train(ds)
    gpu.train(ds.device_cache("cuda"))
    a = torch.cat([v.flatten() for v in cpu.net.state_dict().values() if v.is_floating_point()])
    b = torch.cat([v.flatten().cpu() for v in gpu.net.state_dict().values()
                   if v.is_floating_point()])
    assert float((a - b).abs().max()) <= 2 * 2 * 1e-3 * 1.005
    gpu.net.load_state_dict(cpu.net.state_dict())
    np.testing.assert_allclose(gpu.predict_scores(ds.images), cpu.predict_scores(ds.images),
                               rtol=0, atol=1e-4)


def test_resnet_card_matches_cpu(card):
    """ResNet-18 at 64^2 in eval mode (logits and features within 1e-4)
    and one train-mode pass (the running statistics within rtol 1e-4)."""
    torch.manual_seed(0)
    net = resnet18(num_classes=2)
    gpu = resnet18(num_classes=2).cuda()
    gpu.load_state_dict(net.state_dict())
    x = torch.randn(4, 1, 64, 64)
    for m in (net, gpu):
        m.eval()
    with torch.no_grad():
        lc, fc = net(x, return_features=True)
        lg, fg = gpu(x.cuda(), return_features=True)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        torch.testing.assert_close(fg.cpu(), fc, rtol=0, atol=1e-4)
        net.train()
        gpu.train()
        net(x)
        gpu(x.cuda())
    for k, v in net.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(gpu.state_dict()[k].cpu(), v, rtol=1e-4, atol=1e-6)


def _gan_pair():
    from ich_tpu_torch.models.inpainting import PatchDiscriminator, SAGatedGenerator
    from ich_tpu_torch.train.gan import SNPatchGAN

    out = []
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        g = SAGatedGenerator(lat_channels=4)
        d = PatchDiscriminator(out_channels=(8, 16, 16), kernel_size=3)
        out.append(SNPatchGAN(g, d, batch_size=4, lr_g=1e-5, lr_d=1e-5, device=dev))
    return out


def test_gan_step_card_matches_cpu(card):
    """One SN-PatchGAN step (SAGatedGenerator lat 4, SN discriminator 8-16-16
    with self-attention, batch 4 of 32^2, injected masks, lr 1e-5 so that
    Adam's sign flips on rounding-noise gradients stay below the loss's
    tolerance): G, D and L1 losses within rtol 1e-4, the spectral-norm u
    within 1e-5, every weight within Adam's bound and 99% within 1e-6; the
    two DiscountedL1 terms launch each EDT kernel twice."""
    from ich_tpu_torch.ops.masks import random_ff_masks

    images = torch.from_numpy(np.random.default_rng(0).uniform(size=(4, 32, 32)).astype(np.float32))
    masks = random_ff_masks(prng.prng_key(1), 4, (32, 32), n_draw=(1, 3),
                            vertex=(2, 5), brush_width=(4, 8), length=(4, 10))
    runs = []
    for t in _gan_pair():
        state = t._train_state(1)
        t.generator.train(), t.discriminator.train()
        launches = (edt.launches, edt.mask_launches)
        losses = [float(v) for v in t._step(state, images.to(t.device), None,
                                            masks=masks.to(t.device))]
        moved = (edt.launches - launches[0], edt.mask_launches - launches[1])
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              {**t.generator.state_dict(), **{f"d.{k}": v for k, v in
                               t.discriminator.state_dict().items()}}.items()}, moved))
    (lc, sc, _), (lg, sg, moved) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert moved == (2, 2)
    d = torch.cat([(sc[k] - sg[k]).abs().flatten() for k in sc
                   if sc[k].is_floating_point() and not k.endswith((".u", ".sigma"))
                   and "running" not in k])
    assert float(d.max()) <= 2 * 1.005 * 1e-5 and float((d <= 1e-6).float().mean()) >= 0.99
    for k in sc:
        if k.endswith((".u", ".sigma")):
            assert float((sc[k] - sg[k]).abs().max()) <= 1e-5, k


def test_sn_conv_card_matches_cpu(card):
    """flax's spectral norm on the card: output, u and sigma after a train
    call; eval leaves u as it is."""
    from ich_tpu_torch.models.inpainting import SNConv2d

    torch.manual_seed(2)
    cpu = SNConv2d(6, 32, 5, stride=2, padding=2).train()
    gpu = SNConv2d(6, 32, 5, stride=2, padding=2).cuda().train()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(4, 6, 40, 40)
    with torch.no_grad():
        a, b = cpu(x), gpu(x.cuda()).cpu()
    assert float((a - b).abs().max()) <= 1e-5
    for name in ("u", "sigma"):
        assert float((getattr(cpu, name) - getattr(gpu, name).cpu()).abs().max()) <= 1e-6
    gpu.eval()
    u = gpu.u.clone()
    with torch.no_grad():
        gpu(x.cuda())
    assert torch.equal(gpu.u, u)


def test_detector_device_ops_card_match_cpu(card):
    """The detector's device work on the card against the CPU: morphology
    and hysteresis equal, the free-form mask render equal (draws from one
    key), and detect() with an oracle inpainter, KL and W1 (its null sample
    drawn on each device), equal."""
    from ich_tpu_torch.ops import morphology as morph
    from ich_tpu_torch.ops.masks import draw_ff_masks, render_ff_masks
    from ich_tpu_torch.train.inpaint_ad import InpaintAnomalyDetector

    rng = np.random.default_rng(3)
    m = torch.from_numpy((rng.uniform(size=(3, 64, 48)) > 0.6).astype(np.float32))
    for name in ("dilation", "erosion", "opening", "closing"):
        for size in (3, 5, 7):
            f = getattr(morph, name)
            assert torch.equal(f(m, size), f(m.cuda(), size).cpu()), (name, size)
    x = torch.from_numpy(rng.gamma(1.5, size=(128, 128)).astype(np.float32))
    assert torch.equal(morph.hysteresis_threshold(x, 1.0, 3.0),
                       morph.hysteresis_threshold(x.cuda(), 1.0, 3.0).cpu())
    draws = draw_ff_masks(prng.prng_key(4), 8, (256, 256))
    cpu = render_ff_masks(draws, (256, 256))
    gpu = render_ff_masks({k: v.cuda() for k, v in draws.items()}, (256, 256)).cpu()
    assert float((cpu != gpu).float().mean()) <= 1e-4  # only stroke-edge pixels may differ

    clean = rng.uniform(0.2, 0.4, size=(64, 64)).astype(np.float32)
    image = clean.copy()
    image[20:34, 24:40] = 0.95
    field = rng.normal(size=(64, 64)).astype(np.float32)

    def oracle(imgs, masks):
        w = (np.asarray(masks).reshape(len(masks), -1).sum(1) % 13 / 13.0)[:, None, None, None]
        return imgs * (1 - masks) + (clean + 0.02 * w[..., 0] * field)[..., None] * masks

    kw = dict(grid_hole=(16, 16), grid_step=8, batch_size=8, n_iter=2,
              grid_anomaly_inpaint=((32, 32), (32, 32)))
    for w1 in (False, True):
        a = InpaintAnomalyDetector(oracle, device="cpu", use_wasserstein=w1, **kw).detect(image)
        b = InpaintAnomalyDetector(oracle, device="cuda", use_wasserstein=w1, **kw).detect(image)
        assert np.array_equal(a, b) and a[22:32, 26:38].all(), w1


def _step_pair(build):
    """A trainer on the CPU and one on the card holding the same weights."""
    cpu = build("cpu")
    gpu = build("cuda")
    gpu.net.load_state_dict(cpu.net.state_dict())
    return cpu, gpu


def _params_after(t, step_fn):
    state = t._train_state(1)
    t.net.train()
    loss = float(step_fn(t, state))
    return loss, torch.cat([p.detach().flatten().cpu() for p in t.net.parameters()])


@pytest.mark.parametrize("kind", ["ae", "fcdd"])
def test_ae_fcdd_steps_card_match_cpu(card, kind):
    """One step of the AE (small AENet, lambda 1) or of FCDD (the VGG stack,
    the ellipses and corruption draws injected) at batch 4 of 64^2: the loss
    within rtol 1e-4, every weight within Adam's first-step bound and 98%
    within lr / 10; FCDD's ellipses from one key, rendered on each device,
    equal but for edge pixels."""
    from ich_tpu_torch.models.ae import AENet
    from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG
    from ich_tpu_torch.ops.masks import draw_ellipses_batch
    from ich_tpu_torch.train.ae_trainer import AE
    from ich_tpu_torch.train.fcdd_trainer import FCDD

    lr = 1e-3
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(4, 64, 64)).astype(np.float32))
    if kind == "ae":
        def build(dev):
            torch.manual_seed(0)
            t = AE(AENet(latent_channels=8, bottleneck_channels=8, n_conv=2), batch_size=4,
                   lr=lr, device=dev)
            t.lambda_gdl = 1.0
            return t

        def step(t, state):
            return t._step(state, x.to(t.device), prng.prng_key(6))
    else:
        ell = draw_ellipses_batch(prng.prng_key(6), 4, (64, 64), major_axis=(3, 12),
                                  minor_axis=(2, 8))
        on_card = draw_ellipses_batch(prng.prng_key(6), 4, (64, 64), "cuda", major_axis=(3, 12),
                                      minor_axis=(2, 8))
        assert float((on_card.cpu() != ell).float().mean()) <= 1e-4  # edge pixels only
        u = torch.tensor([0.2, 0.7, 0.1, 0.4])
        labels = torch.tensor([0, 0, 1, 0])

        def build(dev):
            torch.manual_seed(0)
            return FCDD(FCDD_CNN_VGG(), batch_size=4, lr=lr, device=dev)

        def step(t, state):
            return t._step(state, x.to(t.device), labels.to(t.device), None,
                           ellipses=ell.to(t.device), u=u.to(t.device))
    (lc, pc), (lg, pg) = (_params_after(t, step) for t in _step_pair(build))
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    d = (pc - pg).abs()
    assert float(d.max()) <= 2 * 1.005 * lr and float((d <= lr / 10).float().mean()) >= 0.98


def test_gated_unet_step_card_matches_cpu(card):
    """One UNet2D step of the gated U-Net on two channels (depth 4, top 8,
    batch 4 of 64^2, dropout and augmentation off): the loss within rtol
    1e-4, every weight within Adam's first-step bound and 98% within
    lr / 10."""
    lr = 1e-3
    ds = synthetic_ich_slices(n_slices=4, size=64, n_volumes=1, seed=7, positive_frac=1.0)
    x = torch.from_numpy(np.stack([ds.images, ds.masks * 0.7], -1).astype(np.float32))
    y = torch.from_numpy(ds.masks)
    runs = []
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        net = UNet(depth=4, top_filter=8, in_channels=2, p_dropout=0.0, gated=True)
        t = UNet2D(net, batch_size=4, lr=lr, device=dev)
        state = t._train_state(1)
        net.train()
        loss = float(t._step(state, x.to(t.device), y.to(t.device), prng.prng_key(0)))
        runs.append((loss, torch.cat([p.detach().flatten().cpu() for p in net.parameters()])))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    d = (pc - pg).abs()
    assert float(d.max()) <= 2 * 1.005 * lr and float((d <= lr / 10).float().mean()) >= 0.98


def test_ellipse_render_and_upsample_card_match_cpu(card):
    """The ellipse render from one key's draws (equal but for pixels on an
    ellipse's edge, at most 1e-4 of them), the noise drawn on the card equal
    to the CPU's, and the receptive upsample of a 32x32 score map to 256^2
    (within 1e-5 of its scale)."""
    from ich_tpu_torch.models.fcdd import receptive_upsample
    from ich_tpu_torch.ops.masks import draw_ellipse_params, render_ellipses

    draws = draw_ellipse_params(prng.prng_key(8), 32, (256, 256), noise=0.05)
    on_card = draw_ellipse_params(prng.prng_key(8), 32, (256, 256), noise=0.05, device="cuda")
    assert all(torch.equal(draws[k], v.cpu()) for k, v in on_card.items())
    cpu = render_ellipses(draws, (256, 256))
    gpu = render_ellipses({k: v.cuda() for k, v in draws.items()}, (256, 256)).cpu()
    assert float((cpu != gpu).float().mean()) <= 1e-4
    s = torch.randn(4, 1, 32, 32, generator=torch.Generator().manual_seed(9))
    a, b = receptive_upsample(s, (256, 256)), receptive_upsample(s.cuda(), (256, 256)).cpu()
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_normal_draws_on_the_card_equal_the_cpu(card):
    """jax.random's ``normal`` at 2^18 words, which rng computes on the
    device, equals the same draw on the CPU, the far tails (erf_inv's sqrt
    branch) included."""
    key = prng.prng_key(42)
    for shape, k in (((4, 256, 256), key), ((4, 256, 256), prng.split(key, 4))):
        a = prng.normal(k, shape[1:] if k.dim() > 1 else shape, "cuda").cpu()
        b = prng.normal(k, shape[1:] if k.dim() > 1 else shape, "cpu")
        assert float(b.abs().max()) > 4.0  # draws in the tails
        assert torch.equal(a, b)


def test_nccl_world1_step_matches_plain_step(card, tmp_path):
    """A world-1 NCCL group on the card: three ``UNet2D(mesh=)`` steps
    (synced BatchNorm, the gradient all-reduce) against the trainer without
    a mesh, BatchNorm net, batch 4 of 64^2, dropout and augmentation off:
    losses within rtol 1e-5; the weights after step 1 within Adam's bound
    and 98% within lr / 10, the running statistics after it within 1e-4
    (only the normalisation's arithmetic differs)."""
    import torch.distributed as dist

    from ich_tpu_torch import parallel

    lr = 1e-3
    mesh = parallel.init_distributed(device="cuda:0", init_method=f"file://{tmp_path}/store",
                                     world_size=1, rank=0)
    try:
        assert mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0)
        ds = synthetic_ich_slices(n_slices=4, size=64, n_volumes=1, seed=7, positive_frac=1.0)
        x, y = torch.from_numpy(ds.images).cuda(), torch.from_numpy(ds.masks).cuda()
        runs = []
        for m in (None, mesh):
            torch.manual_seed(0)
            net = UNet(depth=4, top_filter=8, p_dropout=0.0, norm="batch")
            t = UNet2D(net, batch_size=4, lr=lr, device="cuda", mesh=m)
            state = t._train_state(1)
            net.train()
            losses = [float(t._step(state, x, y, prng.prng_key(0)))]
            step1 = torch.cat([p.detach().flatten().cpu() for p in net.parameters()])
            stats = torch.cat([b.flatten().cpu() for b in net.buffers() if b.is_floating_point()])
            losses += [float(t._step(state, x, y, prng.prng_key(s))) for s in (1, 2)]
            runs.append((losses, step1, stats))
        (lp, pp, bp), (lm, pm, bm) = runs
        np.testing.assert_allclose(lm, lp, rtol=1e-5)
        d = (pp - pm).abs()
        assert float(d.max()) <= 2 * lr and float((d <= lr / 10).float().mean()) >= 0.98
        torch.testing.assert_close(bm, bp, rtol=1e-4, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_native_loader_builds_on_the_card_machine(card, tmp_path):
    """``ich_tpu_torch.native`` builds with the card machine's g++ and zlib,
    and its decode and window + resize agree with the port's Python codec
    and the card's window + resize."""
    from ich_tpu_torch import native
    from ich_tpu_torch.data import nifti
    from ich_tpu_torch.ops import ct

    assert native.available(), native._error
    rng = np.random.default_rng(11)
    vol = rng.uniform(-200, 300, size=(64, 48, 6)).astype(np.float32)
    fn = str(tmp_path / "v.nii.gz")
    nifti.save(fn, vol, np.diag([0.5, 0.5, 5.0, 1.0]))
    got, pixdim = native.load_nifti_f32(fn)
    np.testing.assert_array_equal(got, nifti.load(fn)[0])
    np.testing.assert_allclose(pixdim, [0.5, 0.5, 5.0])
    slices = np.moveaxis(vol, 2, 0)
    want = ct.resize(ct.window_ct(torch.from_numpy(slices).cuda(), 50, 200), (6, 32, 24),
                     order=1).cpu().numpy()
    np.testing.assert_allclose(native.window_resize_batch(slices, 50, 200, (32, 24)), want,
                               atol=1e-4)


def test_profiling_times_and_traces_the_card(card, tmp_path):
    """``utils/profiling`` on the card: ``time_fn`` on CUDA events (a
    4096^2 matmul takes device time the host clock alone would not see),
    ``sync`` waits and fetches, the trace holds device kernels, and the
    card's name has its data-sheet peaks."""
    from ich_tpu_torch.utils import profiling as prof

    x = torch.randn(4096, 4096, device="cuda")
    out = prof.time_fn(torch.matmul, x, x, iters=5)
    flops = prof.compiled_flops(torch.matmul, x, x)
    assert flops == 2 * 4096 ** 3
    # float32 outside TF32: at most the card's float32 peak, at least 1%
    peak = prof.peak_tflops(torch.cuda.get_device_name(0), "fp32") or 67.0
    assert 0.01 * peak <= flops / out["mean_s"] / 1e12 <= 1.05 * peak
    y = x @ x
    assert prof.sync(y) == float(y[0, 0].cpu())
    with prof.device_trace(str(tmp_path)) as p:
        (x @ x).sum()
        torch.cuda.synchronize()
    assert any(e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               for e in p.key_averages())
    assert (tmp_path / "trace.json").stat().st_size > 0
    if "H100" in torch.cuda.get_device_name(0):
        assert prof.peak_tflops(torch.cuda.get_device_name(0)) is not None
