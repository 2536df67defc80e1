"""Every random transform of ``ich_tpu_torch.ops.transforms`` draws from a
key the parameters that the JAX package's transform draws from the same
key: the integers and flags equal, the floats equal but where a float32
``cos``/``sin``/``exp`` of the two libraries may round apart (within
1e-6); a ``Compose`` of them gives the JAX package's output (masks equal,
images within 1e-5), and so do the patch swap and the region cells."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.ops import losses as JL
from ich_tpu.ops import transforms as JT
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

AFFINE = {
    "Translate": dict(low=-0.1, high=0.1),
    "Rotate": dict(low=-10.0, high=10.0),
    "Scale": dict(low=0.9, high=1.1),
    "HFlip": dict(p=0.5),
    "VFlip": dict(p=0.3),
    "RandomCropResize": dict(crop_scales=(0.4, 0.8)),
}


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
@pytest.mark.parametrize("name", sorted(AFFINE))
def test_affine_params_from_a_key_equal_jax(name, hw):
    for seed in (0, 7):
        jm, jo = JT.__dict__[name](**AFFINE[name]).affine_params(jax.random.PRNGKey(seed), 64, hw)
        m, o = T.__dict__[name](**AFFINE[name]).affine_params(prng_key(seed), 64, hw)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
        if name != "Rotate":
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.mark.parametrize("name", ["AdjustBrightness", "AdjustContrast"])
def test_photometric_factors_from_a_key_equal_jax(name):
    jt, pt = JT.__dict__[name](p=0.4), T.__dict__[name](p=0.4)
    for seed in (0, 7):
        ja, jf = jt._factors(jax.random.PRNGKey(seed), 50)
        pa, pf = pt._factors(prng_key(seed), 50)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


def test_blur_kernels_from_a_key_equal_jax():
    jt, pt = JT.GaussianBlur(0.5, (0.1, 2.0)), T.GaussianBlur(0.5, (0.1, 2.0))
    for seed in (0, 7):
        want = np.asarray(jt._kernels(jax.random.PRNGKey(seed), 40))
        apply, sig = pt.draw(prng_key(seed), 40)
        np.testing.assert_allclose(pt.kernels(apply, sig).numpy(), want, rtol=0, atol=1e-6)


def test_z_crop_starts_from_a_key_equal_jax():
    vol = np.random.default_rng(3).uniform(size=(6, 4, 5, 20)).astype(np.float32)
    want = np.asarray(JT.RandomZCrop(7)(jax.random.PRNGKey(8), jnp.asarray(vol)))
    got = T.RandomZCrop(7)(prng_key(8), torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T.RandomZCrop(7).draw(prng_key(8), 6, 20).numpy(),
                                  np.asarray(jax.random.randint(jax.random.PRNGKey(8), (6,), 0, 13)))


@pytest.mark.parametrize("rotate", [True, False])
def test_patch_swap_from_a_key_equals_jax(rotate):
    """The geometry of every swap (JAX's ``_sample_geom`` on the key tree
    of its ``__call__``) and the corrupted images, exactly."""
    b, n, hw = 6, 4, (32, 32)
    jswap = JT.RandomPatchSwap(n=n, w=(4, 9), h=(5, 8), rotate=rotate)
    pswap = T.RandomPatchSwap(n=n, w=(4, 9), h=(5, 8), rotate=rotate)
    key = jax.random.PRNGKey(21)
    keys = jax.vmap(lambda kb: jax.random.split(kb, n))(jax.random.split(key, b))
    want = jax.vmap(jax.vmap(lambda k: jswap._sample_geom(k, hw)))(keys)
    got = pswap.draw_geometry(prng_key(21), b, hw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    img = np.random.default_rng(4).uniform(size=(b,) + hw).astype(np.float32)
    mask = (img > 0.6).astype(np.float32)
    wi, wm = jswap(key, jnp.asarray(img), jnp.asarray(mask))
    gi, gm = pswap(prng_key(21), torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("shape", [(8, 32, 32), (4, 24, 40, 1)])
def test_compose_from_a_key_equals_jax(shape):
    """The 2.5D config's pipeline and the SimCLR views, whole."""
    draw = np.random.default_rng(0)
    img = draw.uniform(size=shape).astype(np.float32)
    mask = (draw.uniform(size=shape) > 0.7).astype(np.float32)
    seg = [("Translate", dict(low=-0.1, high=0.1)), ("Rotate", dict(low=-10, high=10)),
           ("Scale", dict(low=0.9, high=1.1)), ("HFlip", dict(p=0.5))]
    jpipe = JT.Compose(*(JT.__dict__[n](**kw) for n, kw in seg))
    ppipe = T.Compose(*(T.__dict__[n](**kw) for n, kw in seg))
    wi, wm = jpipe(jax.random.PRNGKey(5), jnp.asarray(img), jnp.asarray(mask))
    gi, gm = ppipe(prng_key(5), torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    jv, pv = (M.Compose(M.RandomCropResize((0.4, 0.8)), M.HFlip(0.5),
                        M.GaussianBlur(0.5, (0.1, 2.0)), M.AdjustBrightness(0.5, -0.2, 0.2),
                        M.AdjustContrast(0.5, 0.8, 1.2)) for M in (JT, T))
    x = img if img.ndim == 4 else img[..., None]
    want = np.asarray(jv(jax.random.PRNGKey(6), jnp.asarray(x)))
    got = pv(prng_key(6), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_region_cells_from_a_key_equal_jax():
    want = np.asarray(JL.sample_region_cells(jax.random.PRNGKey(9), 12, 49, 13))
    got = L.sample_region_cells(prng_key(9), 12, 49, 13).numpy()
    np.testing.assert_array_equal(got, want)
