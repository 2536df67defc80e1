"""The port's 3D patch augmentation (``ich_tpu_torch.ops.transforms3d``) and
photometric jitter against the JAX package's.

Warps are held with the same ``(m, o)``: images within 1e-6, masks equal.
The random transforms draw from a key what the JAX package's draw from it
(angles, flip flags, brightness factors: equal), and a ``Compose3D`` from a
key gives the JAX package's output (masks equal, images within 1e-5); the
draws are also held by their distributions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.ops import transforms as JT
from ich_tpu.ops import transforms3d as JT3
from ich_tpu.ops import warp as JW
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops import transforms3d as T3
from ich_tpu_torch.utils.rng import prng_key
from ich_tpu_torch.utils.config import TRANSFORMS

torch.set_num_threads(2)

SHAPES = {"bdhw": (2, 3, 20, 24), "bdhwc": (2, 3, 20, 24, 1)}


def _jax_affine(seed, b, low=-30.0, high=30.0):
    """A rotation drawn by the JAX package, composed with an H flip."""
    m, o = JT3._rotation_affine(jax.random.PRNGKey(seed), b, low, high)
    sy = jnp.where(jnp.arange(b) % 2 == 0, -1.0, 1.0)
    z, one = jnp.zeros((b,)), jnp.ones((b,))
    flip = jnp.stack([jnp.stack([sy, z], 1), jnp.stack([z, one], 1)], 1)
    m, o = JW.compose_affine(m, o, flip, jnp.zeros((b, 2)))
    return np.array(m), np.array(o)


def _volume(shape, order, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    return (x > 0.6).astype(np.float32) if order == 0 else x


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_warp_inplane_matches_jax(shape, order):
    """Depth folded into the batch, the exact gather: images within 1e-6,
    masks equal."""
    shape = SHAPES[shape]
    x = _volume(shape, order, seed=len(shape) + order)
    m, o = _jax_affine(order, shape[0])
    want = np.asarray(JT3._warp_inplane(jnp.asarray(x), jnp.asarray(m), jnp.asarray(o), 30.0,
                                        order))
    got = T3._warp_inplane(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(o),
                           order).numpy()
    assert got.shape == want.shape == shape
    assert (want == 0).any() and (want != 0).any()  # out-of-bounds and data both sampled
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flip_h,flip_w", [(True, True), (True, False), (False, True)])
def test_affine_augment3d_matches_jax(flip_h, flip_w):
    """From one key, the port draws the JAX package's angles and H / W
    flips (``kr, kh, kw = split(key, 3)``): the composed (m, o) within 1e-6
    of the JAX draws', and the warped (B, D, H, W, 1) image within 1e-5 of
    the JAX package's (XLA may fuse the composition and the angle's cosine
    differently, an ulp of ``m`` moves a sample by about 1e-6) and the mask
    equal."""
    b, key = 4, jax.random.PRNGKey(11)
    aug = dict(rotate=(-10.0, 10.0), p_flip=0.5, flip_h=flip_h, flip_w=flip_w)
    kr, kh, kw = jax.random.split(key, 3)
    angles = np.array(jax.random.uniform(kr, (b,), minval=-10.0, maxval=10.0))
    flags = [np.array(jax.random.bernoulli(k, 0.5, (b,)))
             for k, on in ((kh, flip_h), (kw, flip_w)) if on]
    x = _volume((b, 3, 20, 24, 1), 1, seed=5)
    mask = (x > 0.7).astype(np.float32)
    want_img, want_mask = JT3.AffineAugment3D(**aug)(key, jnp.asarray(x), jnp.asarray(mask))

    port = T3.AffineAugment3D(**aug)
    m, o = port.affine_params(prng_key(11), b)
    sy = np.where(flags[0], -1.0, 1.0) if flip_h else np.ones(b)
    sx = np.where(flags[-1], -1.0, 1.0) if flip_w else np.ones(b)
    th = np.deg2rad(angles.astype(np.float64))
    want_m = np.stack([np.stack([np.cos(th) * sy, np.sin(th) * sx], 1),
                       np.stack([-np.sin(th) * sy, np.cos(th) * sx], 1)], 1)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=0, atol=1e-6)
    assert not o.any()
    got_img, got_mask = port(prng_key(11), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_rotate_inplane_matches_jax():
    b, key = 3, jax.random.PRNGKey(2)
    angles = np.array(jax.random.uniform(key, (b,), minval=-20.0, maxval=20.0))
    x = _volume((b, 2, 16, 16), 1, seed=2)
    want = np.asarray(JT3.RotateInPlane(-20, 20)(key, jnp.asarray(x)))
    m, _ = T3.RotateInPlane(-20, 20).affine_params(prng_key(2), b)
    th = np.deg2rad(angles.astype(np.float64))
    np.testing.assert_allclose(m[:, 0, 0].numpy(), np.cos(th), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m[:, 0, 1].numpy(), np.sin(th), rtol=0, atol=1e-6)
    got = T3.RotateInPlane(-20, 20)(prng_key(2), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # as AffineAugment3D


@pytest.mark.parametrize("axes", [(1,), (2, 3), (1, 2, 3)])
def test_flip3d_matches_jax(axes):
    """The port draws the JAX package's flags from the key
    (``bernoulli(fold_in(key, i))`` per axis): flags, image and mask
    equal."""
    b, key = 6, jax.random.PRNGKey(4)
    flags = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), 0.5, (b,)))
                      for i in range(len(axes))])
    assert flags.any() and not flags.all()
    x = _volume((b, 3, 4, 5, 1), 1, seed=3)
    mask = (x > 0.5).astype(np.float32)[..., 0]
    want_img, want_mask = JT3.Flip3D(0.5, axes)(key, jnp.asarray(x), jnp.asarray(mask))
    flip = T3.Flip3D(0.5, axes)
    flags_t = torch.from_numpy(flags)
    np.testing.assert_array_equal(flip.apply_flags(torch.from_numpy(x), flags_t).numpy(),
                                  np.asarray(want_img))
    np.testing.assert_array_equal(flip.apply_flags(torch.from_numpy(mask), flags_t).numpy(),
                                  np.asarray(want_mask))
    np.testing.assert_array_equal(flip.flip_flags(prng_key(4), b).numpy(), flags)
    got_img, got_mask = flip(prng_key(4), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("shape", [(5, 8, 8, 1), (5, 3, 8, 8, 1)], ids=["rank4", "rank5"])
@pytest.mark.parametrize("name", ["AdjustBrightness", "AdjustContrast"])
def test_photometric_matches_jax(name, shape):
    """The JAX package's (apply, factor) draws injected: within 1e-7; the
    port's own draws from the same key are the JAX package's, and its call
    gives the JAX output; the mask passes through."""
    kw = {"AdjustBrightness": dict(p=0.5, low=-0.3, high=0.3),
          "AdjustContrast": dict(p=0.5, low=0.5, high=1.5)}[name]
    jt, pt = getattr(JT, name)(**kw), getattr(T, name)(**kw)
    key = jax.random.PRNGKey(len(shape))
    apply, f = (np.array(a) for a in jt._factors(key, shape[0]))
    assert apply.any() and not apply.all()
    x = _volume(shape, 1, seed=7)
    mask = (x > 0.5).astype(np.float32)
    want, want_mask = jt(key, jnp.asarray(x), jnp.asarray(mask))
    got = pt.apply_factors(torch.from_numpy(x), torch.from_numpy(apply), torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    papply, pf = pt._factors(prng_key(len(shape)), shape[0])
    np.testing.assert_array_equal(papply.numpy(), apply)
    np.testing.assert_array_equal(pf.numpy(), f)
    out = pt(prng_key(len(shape)), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want), rtol=0, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, {"flip_axes": (1, 2, 3)}, {"brightness": None},
                                {"rotate": (-5, 15), "flip_axes": (2,)}])
def test_default_patch_augmentation_matches_jax(kw):
    """The same parts, with the same parameters, in the same order."""
    got, want = T3.default_patch_augmentation(**kw), JT3.default_patch_augmentation(**kw)
    assert [type(t).__name__ for t in got.transforms] == [type(t).__name__
                                                          for t in want.transforms]
    assert str(got) == str(want)


N = 20000


def _sigma3(var: float) -> float:
    return 3.0 * math.sqrt(var / N)


def test_rotation_and_flip_distributions():
    """Angles uniform on [low, high) (range and mean), flip rates ``p``
    within 3 sigma; AffineAugment3D's flips are the signs of its diagonal
    (|angle| < 90 degrees); each from its own key."""
    m, o = T3.RotateInPlane(-10, 20).affine_params(prng_key(0), N)
    ang = np.degrees(np.arctan2(m[:, 0, 1].double().numpy(), m[:, 0, 0].double().numpy()))
    assert -10 - 1e-4 <= ang.min() < -9.9 and 19.9 < ang.max() <= 20 + 1e-4
    assert abs(ang.mean() - 5.0) <= _sigma3(30.0**2 / 12) and not o.any()
    m, _ = T3.AffineAugment3D((-10, 10), p_flip=0.3).affine_params(prng_key(1), N)
    for axis in (0, 1):
        rate = float((m[:, axis, axis] < 0).double().mean())
        assert abs(rate - 0.3) <= _sigma3(0.3 * 0.7), (axis, rate)
    flags = T3.Flip3D(0.2, axes=(1, 2, 3)).flip_flags(prng_key(2), N)
    assert flags.shape == (3, N)
    assert all(abs(float(f.double().mean()) - 0.2) <= _sigma3(0.2 * 0.8) for f in flags)


def test_compose3d_draws_from_one_generator():
    """Same key, same result; another key, another; the mask stays binary
    and the shapes stay, with and without the channel axis."""
    pipe = T3.default_patch_augmentation(flip_axes=(1, 2, 3))
    for shape in ((4, 6, 16, 16), (4, 6, 16, 16, 1)):
        x = torch.from_numpy(_volume(shape, 1, seed=9))
        mask = (x > 0.6).float()
        a = pipe(prng_key(1), x, mask)
        b = pipe(prng_key(1), x, mask)
        c = pipe(prng_key(2), x, mask)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[0], c[0])
        assert a[0].shape == x.shape and a[1].shape == mask.shape
        assert set(np.unique(a[1].numpy())) <= {0.0, 1.0}
        only = pipe(prng_key(1), x)
        assert torch.equal(only, a[0])


@pytest.mark.parametrize("kw", [{}, {"flip_axes": (1, 2, 3)}, {"brightness": None}])
@pytest.mark.parametrize("seed", [0, 5])
def test_compose3d_from_a_key_equals_jax(kw, seed):
    """``default_patch_augmentation`` from one key: the JAX package's output
    (``split(key, len(transforms))``, each part's draws from its key), the
    mask equal and the image within 1e-5 (as ``AffineAugment3D``)."""
    b = 4
    x = _volume((b, 5, 16, 20, 1), 1, seed=12 + seed)
    mask = (x > 0.6).astype(np.float32)
    want_img, want_mask = JT3.default_patch_augmentation(**kw)(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask))
    got_img, got_mask = T3.default_patch_augmentation(**kw)(
        prng_key(seed), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)


def test_registry_names():
    for name in ("Flip3D", "RotateInPlane", "AffineAugment3D", "AdjustBrightness",
                 "AdjustContrast", "AdjustBrighness"):
        assert name in TRANSFORMS
    pipe = T.build_pipeline({"AdjustBrighness": {"p": 1.0, "low": 0.1, "high": 0.1},
                             "AdjustContrast": {"p": 0.0}})
    assert isinstance(pipe.transforms[0], T.AdjustBrightness)
    assert str(pipe.transforms[0]) == str(JT.AdjustBrightness(p=1.0, low=0.1, high=0.1))
    x = torch.full((2, 4, 4), 0.5)
    np.testing.assert_allclose(pipe(prng_key(0), x).numpy(), 0.6, rtol=0, atol=1e-7)
