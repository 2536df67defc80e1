"""The plain reference against the program at a tiny size on the CPU: the
same nets with one ``state_dict``, and the same draws from the same keys.
(A test may import both; the reference itself imports no program code.)"""

import numpy as np
import pytest
import torch

from portbench.common.weights import load_into
from portbench.nets import unet
from portbench.reference import augment, rng as ref_rng, sampler, unet as ref_unet

PROGRAM = dict(p_dropout=0.0, compute_dtype="float32", in_channels=1, out_channels=1)
NETS = {
    "unet2d_batch": dict(ndim=2, depth=3, top_filter=4, midchannels_factor=1, norm="batch",
                         **PROGRAM),
    "unet3d_group": dict(ndim=3, depth=3, top_filter=16, midchannels_factor=1, norm="group",
                         **PROGRAM),
    "unet2d_mcf2": dict(ndim=2, depth=4, top_filter=8, midchannels_factor=2, norm="batch",
                        **PROGRAM),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(NETS))
def test_reference_unet_matches_the_program(name, train):
    cfg = NETS[name]
    net = unet.build(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    weights = unet.make_weights(cfg, gen, "cpu")
    load_into(net, weights)
    x = torch.rand((2, 1) + (16,) * cfg["ndim"], generator=gen)
    running = ref_unet.running_stats(cfg, "cpu")
    net.train(train)
    got = net(x)
    want = ref_unet.forward(weights, x, cfg, train=train, running=running)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    sd = net.state_dict()
    for k, v in running.items():  # flax's running update, the biased variance
        torch.testing.assert_close(sd[k], v, rtol=0, atol=1e-6)


def test_reference_keys_and_draws_equal_the_programs():
    from ich_tpu_torch.models.init import flax_fold
    from ich_tpu_torch.ops.dropout import flax_dropout_key
    from ich_tpu_torch.utils import rng

    seed = 2**31 + 12345
    key = rng.fold_in(rng.fold_in(rng.prng_key(seed), 4), 7)
    rkey = ref_rng.fold_in(ref_rng.fold_in(ref_rng.prng_key(seed), 4), 7)
    assert key.tolist() == rkey.tolist()
    a, d = rng.split(key)
    ra, rd = ref_rng.split(rkey)
    assert a.tolist() == ra.tolist() and d.tolist() == rd.tolist()
    np.testing.assert_array_equal(rng.uniform(a, (64,), -3.5, 7.25).numpy(),
                                  ref_rng.uniform(ra, (64,), -3.5, 7.25))
    np.testing.assert_array_equal(rng.bernoulli(a, 0.3, (64,)).numpy(),
                                  ref_rng.bernoulli(ra, 0.3, (64,)))
    ks = rng.split(rng.split(key, 16), 4).unbind(-2)
    rks = ref_rng.split(ref_rng.split(rkey, 16), 4)
    lim = np.tile(np.array([3, 448, 200]), (16, 1))
    np.testing.assert_array_equal(rng.randint(ks[3], (3,), 0, torch.from_numpy(lim)).numpy(),
                                  ref_rng.randint(rks[:, 3], (3,), 0, lim))
    path = ("encoder", "down_2", "Dropout_0")
    pkey = flax_dropout_key((int(d[0]), int(d[1]), flax_fold(path, 1)))
    assert pkey == ref_rng.dropout_rbg_key(rd, path)
    assert torch.equal(rng.philox_bits(pkey, 4099, 0, "cpu"), ref_rng.philox_bits(pkey, 4099, "cpu"))


def test_reference_augmentation_equals_the_programs():
    from ich_tpu_torch.ops.transforms import build_pipeline
    from ich_tpu_torch.utils import rng

    spec = {"Translate": {"low": -0.1, "high": 0.1}, "Rotate": {"low": -10, "high": 10},
            "Scale": {"low": 0.9, "high": 1.1}, "HFlip": {"p": 0.5}}
    gen = torch.Generator().manual_seed(0)
    img = torch.rand((6, 24, 20, 1), generator=gen)
    msk = (torch.rand((6, 24, 20, 1), generator=gen) > 0.7).float()
    key = rng.fold_in(rng.prng_key(9), 2)
    got_i, got_m = build_pipeline(spec)(key, img, msk)
    m, o = (torch.from_numpy(a) for a in augment.affine(key.numpy().astype(np.uint32), spec,
                                                         6, 24, 20))
    torch.testing.assert_close(augment.warp(img[..., 0], m, o, 1), got_i[..., 0], rtol=0,
                               atol=1e-6)
    assert torch.equal(augment.warp(msk[..., 0], m, o, 0), got_m[..., 0])


def test_reference_patches_equal_the_device_samplers():
    from ich_tpu_torch.data.core import VolumeDataset3D
    from ich_tpu_torch.data.patch_sampler import DevicePatchSampler
    from ich_tpu_torch.utils import rng

    gen = torch.Generator().manual_seed(1)
    vols = [torch.rand((12, 40, 36), generator=gen) for _ in range(3)]
    masks = [(torch.rand((12, 40, 36), generator=gen) > 0.995).to(torch.uint8) for _ in range(3)]
    masks[1].zero_()
    patch = (8, 16, 16)
    ds = VolumeDataset3D([v.numpy() for v in vols], [m.numpy() for m in masks], np.arange(3))
    prog = DevicePatchSampler(ds, patch, pos_frac=0.5, max_pos=20, device="cpu")
    key = rng.fold_in(rng.prng_key(5), 3)
    got_i, got_m = prog(key, 10)
    tables = sampler.Tables([m.numpy() for m in masks], patch, max_pos=20)
    vi, st = tables.starts(key.numpy().astype(np.uint32), 10, 0.5)
    want_i, want_m = sampler.gather(vols, masks, vi, st, patch)
    assert torch.equal(got_i, want_i) and torch.equal(got_m, want_m)
