"""The port's SSL losses and transforms against the JAX package's.

Each random transform is held with the JAX package's own draws injected
into the port's apply step (``RandomPatchSwap`` exactly, the blur within
1e-5, ``RandomCropResize``'s warp image within 1e-5 and mask equal, the z
crop equal), and the port's samplers, which draw from a jax.random key
(``tests/test_torch_keyed_draws.py`` holds them equal to the JAX
package's), by their distributions too. The losses take the same
embeddings (and, for the local loss, the same region cells) and agree
within rtol 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.ops import losses as JL
from ich_tpu.ops import transforms as JT
from ich_tpu.ops import transforms3d as _jax_transforms3d  # noqa: F401  (registers names)
from ich_tpu.utils.config import TRANSFORMS as JAX_TRANSFORMS
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops import transforms3d as _transforms3d  # noqa: F401  (registers names)
from ich_tpu_torch.utils.rng import prng_key
from ich_tpu_torch.utils.config import LOSSES, TRANSFORMS

torch.set_num_threads(2)


def _sigma3(var, n):
    return 3.0 * math.sqrt(var / n)


# -- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("n,d,tau", [(8, 16, 0.5), (5, 3, 0.1)])
def test_info_nce_matches_jax(n, d, tau):
    rng = np.random.default_rng(n + d)
    z1, z2 = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    want = float(JL.info_nce_loss(jnp.asarray(z1), jnp.asarray(z2), tau=tau))
    got = float(L.info_nce_loss(torch.from_numpy(z1), torch.from_numpy(z2), tau=tau))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # through the registry, as a config names it
    fn = LOSSES.build("InfoNCELoss", set_size=n, tau=tau)
    assert float(fn(torch.from_numpy(z1), torch.from_numpy(z2))) == got


@pytest.mark.parametrize("shape,K,n_region", [((2, 9, 12, 3), 3, 5), ((3, 10, 7, 2), 2, 6)])
def test_local_info_nce_matches_jax_with_injected_cells(shape, K, n_region, monkeypatch):
    """The same cells in both packages (JAX's ``sample_region_cells``
    replaced by the injected draw): the regions, flattened in (y, x, C)
    order with the bottom and right strips dropped, give the same loss."""
    rng = np.random.default_rng(sum(shape))
    f1, f2 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    b, h, w, _ = shape
    cells = np.stack([rng.permutation((h // K) * (w // K))[:n_region] for _ in range(b)])
    monkeypatch.setattr(JL, "sample_region_cells",
                        lambda key, bb, g, r: jnp.asarray(cells.astype(np.int32)))
    want = float(JL.local_info_nce_loss(jnp.asarray(f1), jnp.asarray(f2),
                                        jax.random.PRNGKey(0), tau=0.5, K=K, n_region=n_region))
    got = float(L.local_info_nce_loss(torch.from_numpy(f1), torch.from_numpy(f2), None, tau=0.5,
                                      K=K, n_region=n_region, cells=torch.from_numpy(cells)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="fewer cells"):
        L.local_info_nce_loss(torch.from_numpy(f1), torch.from_numpy(f2), None, K=K,
                              n_region=(h // K) * (w // K) + 1)


def test_sample_region_cells_distinct_and_uniform():
    cells = L.sample_region_cells(prng_key(0), 4000, 20, 5).numpy()
    assert cells.shape == (4000, 5) and cells.min() >= 0 and cells.max() < 20
    assert all(len(set(row)) == 5 for row in cells)
    counts = np.bincount(cells.ravel(), minlength=20) / cells.size
    p = 1 / 20
    assert np.all(np.abs(counts - p) <= _sigma3(p * (1 - p), cells.size) * 1.5)
    # the first cell is uniform too (no bias to low indices)
    first = np.bincount(cells[:, 0], minlength=20) / len(cells)
    assert np.all(np.abs(first - p) <= _sigma3(p * (1 - p), len(cells)) * 1.5)


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss"])
def test_reconstruction_losses_match_jax(name):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(3, 8, 8, 1)).astype(np.float32) for _ in range(2))
    for reduction in ("mean", "sum"):
        want = float(getattr(JL, name)(jnp.asarray(a), jnp.asarray(b), reduction=reduction))
        got = float(getattr(L, name)(torch.from_numpy(a), torch.from_numpy(b),
                                     reduction=reduction))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    reg = {"mse_loss": "MSELoss", "l1_loss": "L1Loss"}[name]
    fn = LOSSES.build(reg, reduction="mean", device="cuda:0")
    np.testing.assert_allclose(float(fn(torch.from_numpy(a), torch.from_numpy(b))),
                               float(getattr(L, name)(torch.from_numpy(a), torch.from_numpy(b))))


# -- RandomPatchSwap -----------------------------------------------------------------

def _jax_geometry(swap, key, b, hw):
    """The geometry JAX's ``__call__`` draws: the key split per sample, then
    per swap, each swap from ``_sample_geom``; as the port's (B, n) tensors."""
    keys = jax.vmap(lambda kb: jax.random.split(kb, swap.n))(jax.random.split(key, b))
    geom = jax.jit(jax.vmap(jax.vmap(lambda k: swap._sample_geom(k, hw))))(keys)
    return tuple(torch.from_numpy(np.array(g)).long() for g in geom)


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_patch_swap_with_injected_geometry_equals_jax(rotate, with_mask):
    b, hw = 4, (32, 40)
    rng = np.random.default_rng(int(rotate) + 2 * int(with_mask))
    img = rng.uniform(size=(b,) + hw).astype(np.float32)
    mask = (rng.uniform(size=(b,) + hw) > 0.5).astype(np.float32)
    jswap = JT.RandomPatchSwap(n=6, w=(4, 12), h=(3, 9), rotate=rotate)
    key = jax.random.PRNGKey(11)
    geom = _jax_geometry(jswap, key, b, hw)
    if rotate:
        assert (geom[4] != 0).any() and (geom[5] != 0).any()
    swap = T.RandomPatchSwap(n=6, w=(4, 12), h=(3, 9), rotate=rotate)
    if with_mask:
        want_img, want_mask = (np.asarray(a) for a in jswap(key, jnp.asarray(img),
                                                              jnp.asarray(mask)))
        got_img, got_mask = swap.apply(torch.from_numpy(img), geom, torch.from_numpy(mask))
        np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    else:
        want_img = np.asarray(jswap(key, jnp.asarray(img)))
        got_img = swap.apply(torch.from_numpy(img), geom)
    np.testing.assert_array_equal(got_img.numpy(), want_img)
    assert not np.array_equal(want_img, img)  # something was swapped


def test_patch_swap_overlapping_fallback_equals_jax():
    """Patches too large to place apart: every candidate overlaps, the
    first is taken, and region 2 is read again after region 1 is written."""
    b, hw = 3, (16, 16)
    img = np.random.default_rng(5).uniform(size=(b,) + hw + (2,)).astype(np.float32)
    jswap = JT.RandomPatchSwap(n=4, w=(10, 12), h=(10, 12), rotate=True)
    key = jax.random.PRNGKey(3)
    geom = _jax_geometry(jswap, key, b, hw)
    d = (geom[2] - geom[3]).abs()
    assert ((d[..., 0] <= geom[0]) & (d[..., 1] <= geom[1])).any()  # an overlapping swap
    want = np.asarray(jswap(key, jnp.asarray(img)))
    got = T.RandomPatchSwap(n=4, w=(10, 12), h=(10, 12), rotate=True).apply(
        torch.from_numpy(img), geom).numpy()
    np.testing.assert_array_equal(got, want)


def test_patch_swap_draws_by_distribution():
    swap = T.RandomPatchSwap(n=10, w=(10, 30), h=(10, 30), rotate=True)
    h, w, p1, p2, r1, r2 = swap.draw_geometry(prng_key(0), 400, (256, 256))
    assert torch.equal(h, w) and h.shape == (400, 10)
    assert h.min() >= 10 and h.max() <= 29
    assert abs(float(h.float().mean()) - 19.5) <= _sigma3((20**2 - 1) / 12, h.numel())
    for p in (p1, p2):
        assert p.min() >= 0 and (p[..., 0] <= 256 - h).all() and (p[..., 1] <= 256 - w).all()
    d = (p1 - p2).abs()
    apart = ~((d[..., 0] <= h) & (d[..., 1] <= w))
    assert apart.float().mean() > 0.999
    for r in (r1, r2):
        freq = np.bincount(r.numpy().ravel(), minlength=4) / r.numel()
        assert np.all(np.abs(freq - 0.25) <= _sigma3(0.1875, r.numel()))
    plain = T.RandomPatchSwap(n=3, w=(4, 8), h=(10, 12))
    h, w, _, _, r1, _ = plain.draw_geometry(prng_key(1), 50, (32, 32))
    assert not torch.equal(h, w) and h.min() >= 10 and w.max() <= 7 and not r1.any()
    # __call__ draws, then applies: same key, same result
    x = torch.rand(2, 32, 32, generator=torch.Generator().manual_seed(2))
    a = plain(prng_key(4), x)
    assert torch.equal(a, plain(prng_key(4), x))


# -- GaussianBlur, RandomCropResize, Resize, RandomZCrop, ToTensor ------------------

@pytest.mark.parametrize("shape", [(6, 24, 20), (3, 16, 16, 2)])
def test_gaussian_blur_with_injected_draws_matches_jax(shape):
    jblur = JT.GaussianBlur(0.5, (0.1, 2.0))
    key = jax.random.PRNGKey(sum(shape))
    kp, ks = jax.random.split(key)
    b = shape[0]
    apply = np.asarray(jax.random.bernoulli(kp, 0.5, (b,)))
    sig = np.asarray(jax.random.uniform(ks, (b,), minval=0.1, maxval=2.0))
    assert apply.any() and not apply.all()
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    want = np.asarray(jblur(key, jnp.asarray(x)))
    got = T.GaussianBlur(0.5, (0.1, 2.0)).apply_params(
        torch.from_numpy(x), torch.from_numpy(apply), torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[~apply], x[~apply])  # a delta kernel: unchanged


def test_gaussian_blur_draws_by_distribution():
    blur = T.GaussianBlur(0.3, (0.5, 1.5))
    apply, sig = blur.draw(prng_key(0), 4000)
    assert abs(float(apply.float().mean()) - 0.3) <= _sigma3(0.21, 4000)
    assert sig.min() >= 0.5 and sig.max() < 1.5
    assert abs(float(sig.mean()) - 1.0) <= _sigma3(1 / 12, 4000)
    assert blur.radius == 6


def _jax_crop_flip_params(key, b, hw):
    jts = (JT.RandomCropResize((0.4, 0.8)), JT.HFlip(0.5))
    keys = jax.random.split(key, 2)
    return [tuple(np.array(a) for a in t.affine_params(k, b, hw)) for k, t in zip(keys, jts)]


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_random_crop_resize_compose_with_injected_params_matches_jax(hw):
    b = 6
    params = _jax_crop_flip_params(jax.random.PRNGKey(hw[1]), b, hw)
    jts = [JT.RandomCropResize((0.4, 0.8)), JT.HFlip(0.5)]
    pts = [T.RandomCropResize((0.4, 0.8)), T.HFlip(0.5)]
    for jt, pt, (mt, ot) in zip(jts, pts, params):
        jt.affine_params = lambda key, bb, s, mt=mt, ot=ot: (jnp.asarray(mt), jnp.asarray(ot))
        pt.affine_params = lambda key, bb, s, mt=mt, ot=ot: (torch.from_numpy(mt),
                                                             torch.from_numpy(ot))
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(b,) + hw).astype(np.float32)
    mask = (rng.uniform(size=(b,) + hw) > 0.6).astype(np.float32)
    want_img, want_mask = JT.Compose(*jts)(jax.random.PRNGKey(0), jnp.asarray(img),
                                           jnp.asarray(mask))
    got_img, got_mask = T.Compose(*pts)(prng_key(0), torch.from_numpy(img),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_random_crop_resize_sampler_by_distribution():
    """The crop's share of the image is uniform on the scale range (where a
    try fits) and the map keeps the crop inside the image."""
    hw, n = (64, 64), 3000
    m, o = T.RandomCropResize((0.4, 0.8)).affine_params(prng_key(0), n, hw)
    jm, jo = (np.asarray(a) for a in JT.RandomCropResize((0.4, 0.8)).affine_params(
        jax.random.PRNGKey(0), n, hw))
    area = (m[:, 0, 0] * m[:, 1, 1]).numpy()
    jarea = jm[:, 0, 0] * jm[:, 1, 1]
    assert abs(area.mean() - jarea.mean()) <= 2 * _sigma3(jarea.var(), n)
    assert abs(area.std() - jarea.std()) <= 0.1 * jarea.std()
    assert np.all(m[:, 0, 1].numpy() == 0) and np.all(m[:, 1, 0].numpy() == 0)
    # the crop's first and last sampled pixels lie inside the input
    cy = (hw[0] - 1) / 2.0
    first = m[:, 0, 0] * (0 - cy) + cy + o[:, 0]
    last = m[:, 0, 0] * (hw[0] - 1 - cy) + cy + o[:, 0]
    assert first.min() >= -0.5 and last.max() <= hw[0] - 0.5


@pytest.mark.parametrize("shape,size", [((3, 40, 30), (16, 20)), ((2, 12, 12, 2), (24, 24))])
def test_resize_matches_jax(shape, size):
    rng = np.random.default_rng(2)
    img = rng.uniform(size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    want_img, want_mask = JT.Resize(*size)(jax.random.PRNGKey(0), jnp.asarray(img),
                                           jnp.asarray(mask))
    got_img, got_mask = T.Resize(*size)(prng_key(0), torch.from_numpy(img),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_random_z_crop_with_injected_offsets_equals_jax():
    rng = np.random.default_rng(3)
    vol = rng.uniform(size=(4, 6, 5, 20)).astype(np.float32)
    mask = (vol > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(8)
    z0 = np.asarray(jax.random.randint(key, (4,), 0, 20 - 7))
    want_v, want_m = JT.RandomZCrop(7)(key, jnp.asarray(vol), jnp.asarray(mask))
    crop = T.RandomZCrop(7)
    got_v = crop.crop(torch.from_numpy(vol), torch.from_numpy(z0).long())
    got_m = crop.crop(torch.from_numpy(mask), torch.from_numpy(z0).long())
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    drawn = crop.draw(prng_key(0), 2000, 20)
    assert drawn.min() == 0 and drawn.max() == 12
    one = crop(prng_key(0), torch.from_numpy(vol[0]))
    assert one.shape == (6, 5, 7)


def test_to_tensor_matches_jax():
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    want_x, want_m = JT.ToTensor()(None, jnp.asarray(x), jnp.asarray(x > 5))
    got_x, got_m = T.ToTensor()(None, torch.from_numpy(x), torch.from_numpy(x > 5))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert T.ToTensor()(None, torch.from_numpy(x[0])).shape == (3, 4, 1)
    assert TRANSFORMS.get("ToTorchTensor") is T.ToTensor


def test_every_jax_transform_name_builds_in_the_port():
    names = sorted(JAX_TRANSFORMS)
    assert sorted(TRANSFORMS) == names
    for name in names:
        kw = {"Z": 4} if name == "RandomZCrop" else {}
        pipe = T.build_pipeline({name: kw})
        assert len(pipe.transforms) == 1
        assert type(pipe.transforms[0]).__name__ == type(JAX_TRANSFORMS.build(name, **kw)).__name__
