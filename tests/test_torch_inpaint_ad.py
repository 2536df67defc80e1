"""The port's inpainting anomaly detector, morphology and free-form mask
render (ich_tpu_torch.train.inpaint_ad, ops.morphology, ops.masks) against
ich_tpu's, on numpy-seeded inputs.

Held: the grid masks, dilation / erosion / opening / closing and the
hysteresis threshold equal; the KL map at rtol 1e-5; W1 with JAX's null
draws injected at atol 1e-6; ``detect`` and ``robust_anomaly_detect`` with
an oracle inpainter (W1's null sample drawn by the port from the JAX
package's keys): the first distance map at rtol 1e-5 and the masks
equal but where a pixel's map value lies within 1e-5 of a threshold (those
pixels are counted and printed); the anomaly map of the ensemble equal; the
mask render with JAX's draws equal but at pixels within 1e-4 of a stroke's
edge (counted); the PNG artifacts pixel-equal to the JAX package's PIL
files."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ich_tpu.train.inpaint_ad as jad
from ich_tpu.ops import masks as JM
from ich_tpu.ops import morphology as jmorph
from ich_tpu_torch.data.png import read_png_gray
from ich_tpu_torch.ops import masks as M
from ich_tpu_torch.ops import morphology as morph
from ich_tpu_torch.train import inpaint_ad as ad
from ich_tpu_torch.utils.rng import prng_key

NEAR = 1e-5  # a map value this close to a threshold may fall either side


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("shape,hole,step", [((32, 32), (8, 8), 4), ((63, 63), (32, 32), 16),
                                             ((50, 70), (16, 16), 4), ((256, 256), (32, 32), 16)])
def test_grid_masks_equal_jax(shape, hole, step):
    np.testing.assert_array_equal(ad.make_grid_masks(shape, hole, step),
                                  jad.make_grid_masks(shape, hole, step))


@pytest.mark.parametrize("size", [3, 4, 5, 7])
def test_morphology_equal_jax(size):
    m = (np.random.default_rng(size).uniform(size=(2, 24, 20)) > 0.6).astype(np.float32)
    for name in ("dilation", "erosion", "opening", "closing"):
        want = np.asarray(getattr(jmorph, name)(jnp.asarray(m), size))
        np.testing.assert_array_equal(getattr(morph, name)(_t(m), size).numpy(), want)


def test_hysteresis_and_quantile_thresholds_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.gamma(1.5, size=(64, 64)).astype(np.float32)
    x[10:30, 5:9] = 7.0
    for low, high in ((1.0, 3.0), (2.0, 6.0), (0.5, 0.5)):
        want = np.asarray(jmorph.hysteresis_threshold(jnp.asarray(x), low, high))
        np.testing.assert_array_equal(morph.hysteresis_threshold(_t(x), low, high).numpy(), want)
    snake = np.zeros((40, 40), np.float32)  # a long weak path grown from one seed
    snake[::4, :] = 0.6
    snake[:, 0] = 0.6
    snake[0, 0] = 1.0
    want = np.asarray(jmorph.hysteresis_threshold(jnp.asarray(snake), 0.5, 0.9))
    got = morph.hysteresis_threshold(_t(snake), 0.5, 0.9).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[::4].all()
    capped = np.asarray(jmorph.hysteresis_threshold(jnp.asarray(snake), 0.5, 0.9, max_iter=5))
    np.testing.assert_array_equal(
        morph.hysteresis_threshold(_t(snake), 0.5, 0.9, max_iter=5).numpy(), capped)
    assert capped.sum() < want.sum()
    lo, hi = morph.quantile_iqr_thresholds(_t(x), 1.5)
    jlo, jhi = jmorph.quantile_iqr_thresholds(jnp.asarray(x), 1.5)
    np.testing.assert_allclose([float(lo), float(hi)], [float(jlo), float(jhi)], rtol=1e-6)


def test_kl_and_w1_match_jax():
    rng = np.random.default_rng(4)
    m1, m2 = rng.normal(size=(2, 32, 32)).astype(np.float32)
    s1, s2 = rng.uniform(0.1, 2.0, size=(2, 32, 32)).astype(np.float32)
    want = np.asarray(jad.InpaintAnomalyDetector.kl_divergence_normal(
        (jnp.asarray(m1), jnp.asarray(s1)), (jnp.asarray(m2), jnp.asarray(s2))))
    got = ad.InpaintAnomalyDetector.kl_divergence_normal((_t(m1), _t(s1)), (_t(m2), _t(s2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    err = rng.normal(size=(12, 16, 16)).astype(np.float32)
    grid = (rng.uniform(size=(12, 16, 16)) > 0.4).astype(np.float32)
    p0 = np.sort(rng.normal(size=(3, 16, 16)).astype(np.float32), axis=0)
    want = np.asarray(jad.InpaintAnomalyDetector.pixelwise_wasserstein_1(
        jnp.asarray(p0), jnp.asarray(err), jnp.asarray(grid), 3))
    got = ad.InpaintAnomalyDetector.pixelwise_wasserstein_1(_t(p0), _t(err), _t(grid), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


FIELD = np.random.default_rng(11).normal(size=(32, 32)).astype(np.float32)


def _wobble(masks):
    """A per-sample weight of the oracle's error field, from the mask's
    area: errors then vary from grid to grid, so the maps are not flat."""
    area = np.asarray(masks, np.float32).reshape(len(masks), -1).sum(1)
    return ((area % 13) / 13.0).astype(np.float32)[:, None, None, None]


class _JaxOracle:
    """Inpainter of a known clean image, off by a small field weighted per
    sample (the JAX tests' oracle, made noisy)."""

    def __init__(self, clean):
        self.clean = jnp.asarray(clean, jnp.float32)[None, ..., None]

    def __call__(self, imgs, masks):
        fill = self.clean + 0.02 * jnp.asarray(_wobble(masks)) * FIELD[None, ..., None]
        return imgs * (1 - masks) + fill * masks


def _port_oracle(clean):
    c = np.asarray(clean, np.float32)[None, ..., None]
    return lambda imgs, masks: (imgs * (1 - masks)
                                + (c + 0.02 * _wobble(masks) * FIELD[None, ..., None]) * masks)


def _scene(size=32, seed=2):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.2, 0.4, size=(size, size)).astype(np.float32)
    image = clean.copy()
    image[size // 3: size // 3 + size // 4, size // 3: size // 3 + size // 4] = 0.95
    image[5:8, size - 9: size - 5] = 0.7
    return clean, image


def _recording(monkeypatch, cls, rec):
    """Record every (distance map, t_low, t_high) the detector thresholds."""
    orig = cls._threshold

    def threshold(self, dmap, a_low, a_high):
        d = np.asarray(dmap.cpu() if isinstance(dmap, torch.Tensor) else dmap, np.float64)
        q25, q75 = np.quantile(d, 0.25), np.quantile(d, 0.75)
        rec.append((d, q75 + (q75 - q25) * a_low, q75 + (q75 - q25) * a_high))
        return orig(self, dmap, a_low, a_high)

    monkeypatch.setattr(cls, "_threshold", threshold)


def _near(rec) -> np.ndarray:
    """Pixels whose map value is within NEAR (relative to the threshold,
    absolute below 1) of one of its thresholds, in any pass."""
    out = np.zeros(rec[0][0].shape, bool)
    for d, lo, hi in rec:
        for t in (lo, hi):
            out |= np.abs(d - t) <= NEAR * max(1.0, abs(t))
    return out


KW = dict(grid_hole=(8, 8), grid_step=4, batch_size=4, n_iter=2, early_stop=False,
          grid_anomaly_inpaint=((16, 16), (16, 16)), seed=3)


@pytest.mark.parametrize("wasserstein", [False, True])
def test_detect_matches_jax_with_an_oracle(monkeypatch, wasserstein):
    clean, image = _scene()
    jrec, prec = [], []
    _recording(monkeypatch, jad.InpaintAnomalyDetector, jrec)
    _recording(monkeypatch, ad.InpaintAnomalyDetector, prec)
    jdet = jad.InpaintAnomalyDetector(_JaxOracle(clean), use_wasserstein=wasserstein, **KW)
    pdet = ad.InpaintAnomalyDetector(_port_oracle(clean), use_wasserstein=wasserstein,
                                     device="cpu", **KW)
    want = np.asarray(jdet.detect(image))
    got = pdet.detect(image)
    assert len(jrec) == len(prec) == 1 + KW["n_iter"]
    np.testing.assert_allclose(prec[0][0], jrec[0][0], rtol=1e-5, atol=1e-6)
    near = _near(prec)
    differ = got != want
    print(f"detect (W1 {wasserstein}): {int(near.sum())} pixels within {NEAR} of a threshold, "
          f"{int(differ.sum())} differ")
    assert not (differ & ~near).any()
    assert got[12:18, 12:18].all()  # the planted square is found


def test_robust_anomaly_detect_matches_jax(monkeypatch):
    clean, image = _scene(seed=5)
    jrec, prec = [], []
    _recording(monkeypatch, jad.InpaintAnomalyDetector, jrec)
    _recording(monkeypatch, ad.InpaintAnomalyDetector, prec)
    kw = {**KW, "n_iter": 1}
    jdet = jad.InpaintAnomalyDetector(_JaxOracle(clean), **kw)
    pdet = ad.InpaintAnomalyDetector(_port_oracle(clean), device="cpu", **kw)
    jfinal, jmap = jad.robust_anomaly_detect(image, jdet, angles_list=[7.5], flip=True)
    pfinal, pmap = ad.robust_anomaly_detect(image, pdet, angles_list=[7.5], flip=True)
    near = _near(prec)
    differ = pfinal != np.asarray(jfinal)
    print(f"robust_anomaly_detect: {int(near.sum())} pixels near a threshold over "
          f"{len(prec)} passes, {int(differ.sum())} final pixels differ")
    assert len(jrec) == len(prec) == 4 * (1 + kw["n_iter"])  # 4 detects
    assert not (differ & ~near).any()
    assert not ((pmap != jmap) & ~near).any()
    assert pfinal.shape == (32, 32) and pfinal[12:18, 12:18].mean() > 0.5


def test_detect_artifacts_match_jax_pngs(tmp_path):
    from PIL import Image

    clean, image = _scene(seed=7)
    kw = {**KW, "n_iter": 1}
    jad.InpaintAnomalyDetector(_JaxOracle(clean), **kw).detect(image, save_dir=str(tmp_path / "j"))
    ad.InpaintAnomalyDetector(_port_oracle(clean), device="cpu", **kw).detect(
        image, save_dir=str(tmp_path / "p"))
    for fn in ("D0.png", "mA0.png", "im_corrected_0.png", "D1.png", "mA1.png",
               "im_corrected_1.png"):
        want = np.asarray(Image.open(tmp_path / "j" / fn))
        got = read_png_gray(str(tmp_path / "p" / fn))
        if fn.startswith("D"):  # a rescaled float map: one grey level of rounding
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, fn
        else:
            np.testing.assert_array_equal(got, want, err_msg=fn)


def _jax_draws(key, shape, n_draw=(1, 4), vertex=(5, 15), brush_width=(10, 25),
               angle=(0.5, 2.0), length=(10, 40), n_salt_pepper=(0, 10),
               salt_pepper_radius=(1, 5)):
    """The draws of ``ich_tpu.ops.masks.random_ff_mask(key, ...)``, replayed
    with its key splits."""
    h, w = shape
    kd, kv, kb, ks, kw_, kn, ka, kl, ksp = jax.random.split(key, 9)
    d, v, s = n_draw[1] - 1, vertex[1] - 1, max(n_salt_pepper[1] - 1, 0)
    out = dict(
        n_strokes=jax.random.randint(kd, (), n_draw[0], n_draw[1]),
        n_vert=jax.random.randint(kv, (d,), vertex[0], vertex[1]),
        width=jax.random.randint(kb, (d,), brush_width[0], brush_width[1]),
        sx=jax.random.normal(ks, (d,)) * (w / 8) + w / 2,
        sy=jax.random.normal(kw_, (d,)) * (h / 8) + h / 2,
        beta=jax.random.uniform(kn, (d,), minval=0.0, maxval=6.28),
        angs=jax.random.uniform(ka, (d, v), minval=angle[0], maxval=angle[1]),
        lens=jax.random.randint(kl, (d, v), length[0], length[1]).astype(jnp.float32))
    if s > 0:
        k1, k2, k3, k4 = jax.random.split(ksp, 4)
        out.update(n_sp=jax.random.randint(k1, (), n_salt_pepper[0], n_salt_pepper[1]),
                   cy=jax.random.randint(k2, (s,), 0, h).astype(jnp.float32),
                   cx=jax.random.randint(k3, (s,), 0, w).astype(jnp.float32),
                   r=jax.random.randint(k4, (s,), salt_pepper_radius[0],
                                        salt_pepper_radius[1]).astype(jnp.float32))
    return {k: np.asarray(x) for k, x in out.items()}


def _edge_pixels(draws, shape) -> np.ndarray:
    """Pixels within 1e-4 of a valid stroke segment's edge (float64)."""
    h, w = shape
    a = draws["beta"][:, None] + draws["angs"] + np.where(np.arange(draws["angs"].shape[1]) % 2 == 0,
                                                           math.pi, 0.0)
    ys = np.concatenate([draws["sy"][:, None], draws["sy"][:, None]
                         + np.cumsum(draws["lens"] * np.cos(a), 1)], 1)
    xs = np.concatenate([draws["sx"][:, None], draws["sx"][:, None]
                         + np.cumsum(draws["lens"] * np.sin(a), 1)], 1)
    py, px = np.mgrid[0:h, 0:w].astype(np.float64)
    near = np.zeros(shape, bool)
    for i in range(int(draws["n_strokes"])):
        for j in range(int(draws["n_vert"][i])):
            y0, x0, y1, x1 = ys[i, j], xs[i, j], ys[i, j + 1], xs[i, j + 1]
            dy, dx = y1 - y0, x1 - x0
            t = np.clip(((py - y0) * dy + (px - x0) * dx) / (dy * dy + dx * dx + 1e-8), 0, 1)
            dist = np.hypot(py - y0 - t * dy, px - x0 - t * dx)
            near |= np.abs(dist - draws["width"][i] / 2.0) < 1e-4
    return near


CONFIG_MASK = dict(n_draw=(1, 4), vertex=(5, 15), brush_width=(10, 25), length=(10, 40),
                   n_salt_pepper=(0, 10), salt_pepper_radius=(1, 5))


def test_mask_render_with_jax_draws_matches_jax():
    """The config's mask ranges at 96^2, eight keys: the render given JAX's
    draws equals random_ff_mask but at stroke-edge pixels."""
    shape, n_edge, n_diff = (96, 96), 0, 0
    for i in range(8):
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(JM.random_ff_mask(key, shape, **CONFIG_MASK))
        draws = _jax_draws(key, shape, **CONFIG_MASK)
        batched = {k: torch.from_numpy(np.array(v))[None] for k, v in draws.items()}
        got = M.render_ff_masks(batched, shape)[0].numpy()
        edge = _edge_pixels(draws, shape)
        diff = got != want
        assert not (diff & ~edge).any()
        n_edge, n_diff = n_edge + int(edge.sum()), n_diff + int(diff.sum())
        assert 0.0 < want.mean() < 0.9
    print(f"mask render: {n_diff} pixels differ, {n_edge} within 1e-4 of a stroke's edge")


def test_mask_draws_follow_the_jax_ranges():
    d = M.draw_ff_masks(prng_key(0), 256, (64, 80), **CONFIG_MASK)
    assert d["n_strokes"].min() >= 1 and d["n_strokes"].max() == 3
    assert d["n_vert"].min() == 5 and d["n_vert"].max() == 14 and d["n_vert"].shape == (256, 3)
    assert d["width"].min() == 10 and d["width"].max() == 24
    assert d["lens"].min() == 10 and d["lens"].max() == 39 and d["lens"].shape == (256, 3, 14)
    assert 0.5 <= float(d["angs"].min()) and float(d["angs"].max()) < 2.0
    assert 0.0 <= float(d["beta"].min()) and float(d["beta"].max()) < 6.28
    assert abs(float(d["sx"].mean()) - 40) < 2 and abs(float(d["sx"].std()) - 10) < 1
    assert abs(float(d["sy"].mean()) - 32) < 2 and abs(float(d["sy"].std()) - 8) < 1
    assert d["n_sp"].max() == 9 and d["cy"].max() <= 63 and d["cx"].max() <= 79
    assert d["r"].min() == 1 and d["r"].max() == 4
    m = M.random_ff_masks(prng_key(1), 4, (64, 64), **CONFIG_MASK)
    assert m.shape == (4, 64, 64) and set(torch.unique(m).tolist()) <= {0.0, 1.0}
    assert (m.reshape(4, -1).sum(1) > 0).all()


def test_detector_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ad.InpaintAnomalyDetector(lambda a, b: a)
