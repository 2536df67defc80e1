"""The port's warp and augmentation pipeline against the JAX package's.

The warp is held with the same ``(m, o)``, drawn by JAX's Translate /
Rotate / Scale / HFlip and composed by JAX: order 0 (masks) must be equal,
order 1 (images) within 1e-5. ``Compose`` is held with the parameters
injected into both packages' transforms; the port's samplers, which draw
from a jax.random key (``tests/test_torch_keyed_draws.py`` holds them equal
to the JAX package's), are held by their distributions too."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.ops import transforms as JT
from ich_tpu.ops import warp as JW
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops import warp as W
from ich_tpu_torch.utils.rng import prng_key
from ich_tpu_torch.utils.config import TRANSFORMS

torch.set_num_threads(2)

CONFIG_SPEC = {  # configs/unet2d.json, data.augmentation.train
    "Translate": {"low": -0.1, "high": 0.1},
    "Rotate": {"low": -10, "high": 10},
    "Scale": {"low": 0.9, "high": 1.1},
    "HFlip": {"p": 0.5},
}


def _jax_transforms():
    return [getattr(JT, name)(**kw) for name, kw in CONFIG_SPEC.items()]


def _port_transforms():
    return [getattr(T, name)(**kw) for name, kw in CONFIG_SPEC.items()]


def _jax_params(seed, b, hw):
    """Per-transform (m, o) drawn by the JAX package's samplers."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return [tuple(np.array(a) for a in t.affine_params(k, b, hw))
            for k, t in zip(keys, _jax_transforms())]


def _jax_composed(seed, b, hw):
    m, o = JW.identity_affine(b)
    for mt, ot in _jax_params(seed, b, hw):
        m, o = JW.compose_affine(m, o, jnp.asarray(mt), jnp.asarray(ot))
    return np.array(m), np.array(o)


SHAPES = {
    "channel_less_32": (6, 32, 32),
    "channels3_32": (4, 32, 32, 3),
    "non_square_24x40": (6, 24, 40),
    "non_square_24x40_channels2": (3, 24, 40, 2),
}


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_affine_warp_matches_jax_gather(shape, order):
    shape = SHAPES[shape]
    rng = np.random.default_rng(sum(shape) + order)
    img = rng.uniform(size=shape).astype(np.float32)
    if order == 0:
        img = (img > 0.6).astype(np.float32)
    m, o = _jax_composed(len(shape) + order, shape[0], shape[1:3])
    want = np.asarray(JW.affine_warp(jnp.asarray(img), jnp.asarray(m), jnp.asarray(o),
                                     order=order, method="gather"))
    got = W.affine_warp(torch.from_numpy(img), torch.from_numpy(m), torch.from_numpy(o),
                        order=order).numpy()
    assert got.shape == want.shape == shape
    assert (want == 0).any() and (want != 0).any()  # out-of-bounds and data both sampled
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_compose_affine_matches_jax():
    b, hw = 5, (24, 40)
    params = _jax_params(3, b, hw)
    m, o = W.identity_affine(b)
    for mt, ot in params:
        m, o = W.compose_affine(m, o, torch.from_numpy(mt), torch.from_numpy(ot))
    want_m, want_o = _jax_composed(3, b, hw)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=0, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 32, 32), (4, 24, 40, 1)])
def test_compose_with_injected_params_matches_jax(shape):
    """The config's four transforms fused into one warp that the image
    (order 1, within 1e-5) and the mask (order 0, equal) share."""
    b, hw = shape[0], shape[1:3]
    params = _jax_params(7, b, hw)
    jts, pts = _jax_transforms(), _port_transforms()
    for jt, pt, (mt, ot) in zip(jts, pts, params):
        jt.affine_params = lambda key, bb, hhww, mt=mt, ot=ot: (jnp.asarray(mt), jnp.asarray(ot))
        pt.affine_params = (lambda key, bb, hhww, mt=mt, ot=ot:
                            (torch.from_numpy(mt), torch.from_numpy(ot)))
    draw = np.random.default_rng(0)
    img = draw.uniform(size=shape).astype(np.float32)
    mask = (draw.uniform(size=shape) > 0.7).astype(np.float32)
    want_img, want_mask = JT.Compose(*jts)(jax.random.PRNGKey(0), jnp.asarray(img),
                                           jnp.asarray(mask))
    got_img, got_mask = T.Compose(*pts)(prng_key(0), torch.from_numpy(img),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert set(np.unique(got_mask.numpy())) <= {0.0, 1.0}
    # image only, and one unbatched (H, W) image
    only = T.Compose(*pts)(prng_key(0), torch.from_numpy(img))
    np.testing.assert_array_equal(only.numpy(), got_img.numpy())


N = 20000


def _sigma3(var: float) -> float:
    return 3.0 * math.sqrt(var / N)


def test_translate_distribution():
    key = prng_key(0)
    h, w = 24, 40
    m, o = T.Translate(-0.1, 0.1).affine_params(key, N, (h, w))
    assert torch.equal(m, W.identity_affine(N)[0])
    for axis, n in ((0, h), (1, w)):
        s = -o[:, axis].double().numpy()
        lo, hi = -0.1 * n, 0.1 * n
        assert lo <= s.min() and s.max() <= hi
        assert s.min() < lo + 0.01 * n and s.max() > hi - 0.01 * n
        assert abs(s.mean()) <= _sigma3((hi - lo) ** 2 / 12)


def test_rotate_distribution():
    key = prng_key(1)
    m, o = T.Rotate(-10, 10).affine_params(key, N, (32, 32))
    ang = np.degrees(np.arctan2(m[:, 0, 1].double().numpy(), m[:, 0, 0].double().numpy()))
    np.testing.assert_allclose(m[:, 1, 1], m[:, 0, 0])
    np.testing.assert_allclose(m[:, 1, 0], -m[:, 0, 1])
    assert -10 - 1e-4 <= ang.min() and ang.max() <= 10 + 1e-4
    assert abs(ang.mean()) <= _sigma3(20.0**2 / 12)
    assert not o.any()


def test_scale_distribution():
    key = prng_key(2)
    m, _ = T.Scale(0.9, 1.1).affine_params(key, N, (32, 32))
    s = 1.0 / m[:, 0, 0].double().numpy()
    np.testing.assert_array_equal(m[:, 0, 0], m[:, 1, 1])
    assert not m[:, 0, 1].any() and not m[:, 1, 0].any()
    assert 0.9 - 1e-6 <= s.min() and s.max() <= 1.1 + 1e-6
    assert abs(s.mean() - 1.0) <= _sigma3(0.2**2 / 12)


@pytest.mark.parametrize("cls,axis", [(T.HFlip, 1), (T.VFlip, 0)])
@pytest.mark.parametrize("p", [0.5, 0.2])
def test_flip_rate(cls, axis, p):
    key = prng_key(3)
    m, _ = cls(p).affine_params(key, N, (32, 32))
    sign = m[:, axis, axis].numpy()
    assert set(np.unique(sign)) <= {-1.0, 1.0}
    assert np.all(m[:, 1 - axis, 1 - axis].numpy() == 1.0)
    assert abs(np.mean(sign < 0) - p) <= _sigma3(p * (1 - p))


def test_same_seed_same_draws_and_flip_moves_pixels():
    x = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    pipe = T.build_pipeline(CONFIG_SPEC)
    a = pipe(prng_key(5), x, (x > 20).float())
    b = pipe(prng_key(5), x, (x > 20).float())
    c = pipe(prng_key(6), x, (x > 20).float())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    flipped = T.HFlip(p=1.0)(prng_key(0), x)
    np.testing.assert_array_equal(flipped.numpy(), x.numpy()[:, :, ::-1])


def test_build_pipeline_registry_and_not_ported():
    """Every name of the JAX package's ``TRANSFORMS`` registry builds in the
    port (nothing is left unported), with its kwargs, as the same class."""
    from ich_tpu.utils.config import TRANSFORMS as JAX_TRANSFORMS

    pipe = T.build_pipeline(CONFIG_SPEC)
    assert [type(t).__name__ for t in pipe.transforms] == list(CONFIG_SPEC)
    assert "Translate(low=-0.1, high=0.1)" in str(pipe)
    both = pipe + T.VFlip(0.3)
    assert len(both.transforms) == 5 and isinstance(both, T.Compose)
    assert not hasattr(T, "NOT_PORTED")
    for name in JAX_TRANSFORMS:
        if name in ("Flip3D", "RotateInPlane", "AffineAugment3D"):
            continue  # ich_tpu_torch.ops.transforms3d registers these
        assert name in TRANSFORMS, name
        kw = {"Z": 4} if name == "RandomZCrop" else {}
        built = T.build_pipeline({name: kw}).transforms[0]
        assert type(built).__name__ == type(JAX_TRANSFORMS.build(name, **kw)).__name__, name
