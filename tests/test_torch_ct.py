"""The port's CT ops and metrics against the JAX package on the same
numpy-seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

from ich_tpu.ops import ct as jct
from ich_tpu.ops import metrics as jmetrics
from ich_tpu_torch.ops import ct
from ich_tpu_torch.ops import metrics

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_window_ct_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1000, 1500, size=(16, 12, 3)).astype(dtype)
    for center, width, out_range in [(50.0, 200.0, (0.0, 1.0)), (40.0, 120.0, (-1.0, 1.0))]:
        want = np.asarray(jct.window_ct(jnp.asarray(x), center, width, out_range))
        got = ct.window_ct(torch.from_numpy(x), center, width, out_range).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((64, 64, 5), (32, 32, 5)), ((48, 40, 7), (40, 48, 7)),
                                     ((20, 30, 4), (33, 17, 4)), ((32, 32), (32, 96))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_nearest_is_exact(src, dst, dtype):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 255, size=src).astype(dtype)
    want = np.asarray(jct.resize_nearest(jnp.asarray(x), dst))
    got = ct.resize_nearest(torch.from_numpy(x), dst).numpy()
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ct.resize(torch.from_numpy(x), dst, order=0).numpy(), want)


@pytest.mark.parametrize("n_in,n_out", [(64, 32), (48, 32), (20, 32), (32, 64), (32, 48)])
def test_resize_linear_matches_jax(n_in, n_out):
    """Downsampling antialiases as jax.image.resize does; 48->32 and 32->48
    are non-integer factors."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, size=(n_in, n_in + 4, 3)).astype(np.float32)
    shape = (n_out, n_out + 2, 3)
    want = np.asarray(jct.resize(jnp.asarray(x), shape, order=1))
    got = ct.resize(torch.from_numpy(x), shape, order=1).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_rejects_other_orders():
    with pytest.raises(ValueError):
        ct.resize(torch.zeros(4, 4), (2, 2), order=3)


def test_confusion_counts_and_dice_match_jax():
    rng = np.random.default_rng(3)
    pred = (rng.uniform(size=(5, 16, 16)) > 0.6).astype(np.float32)
    target = (rng.uniform(size=(5, 16, 16)) > 0.7).astype(np.float32)
    want = jmetrics.batch_binary_confusion_matrix(jnp.asarray(pred), jnp.asarray(target))
    got = metrics.batch_binary_confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tn, fp, fn, tp = got
    np.testing.assert_allclose(
        metrics.dice_from_counts(tp, fp, fn).numpy(),
        np.asarray(jmetrics.dice_from_counts(*(jnp.asarray(a.numpy()) for a in (tp, fp, fn)))),
        rtol=1e-7)
    with pytest.raises(ValueError):
        metrics.batch_binary_confusion_matrix(torch.zeros(2, 3), torch.zeros(2, 4))


@pytest.mark.parametrize("n_in,n_out", [(48, 24), (20, 33), (33, 20), (10, 10), (7, 1), (24, 48)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_nearest_zoom_matches_jax_and_scipy(n_in, n_out, dtype):
    """scipy.ndimage.zoom's endpoint-aligned round-half-up grid. 48->24 is
    the case where scipy lands the last coordinate just outside the axis and
    zeroes it; the JAX package and the port clamp it, so the last index is
    left out of the scipy comparison and held against JAX only."""
    rng = np.random.default_rng(4)
    x = rng.integers(1, 255, size=(n_in, 6, 3)).astype(dtype)
    shape = (n_out, 6, 3)
    want = np.asarray(jct.resize_nearest_zoom(jnp.asarray(x), shape))
    got = ct.resize_nearest_zoom(torch.from_numpy(x), shape).numpy()
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, want)
    if n_out > 1:
        scipy_ = ndi.zoom(x, (n_out / n_in, 1, 1), order=0, grid_mode=False)
        np.testing.assert_array_equal(got[:-1], scipy_[:-1])


@pytest.mark.parametrize("src,dst", [((48, 24, 5), (24, 24, 5)), ((20, 24, 10), (10, 12, 20)),
                                     ((16, 9, 4), (37, 9, 3))])
def test_resize_linear_zoom_matches_jax(src, dst):
    """Endpoint-aligned linear, no antialias: within 1e-5 of
    jax.image.scale_and_translate (float32 weights on both sides), and
    within 1e-4 of scipy.ndimage.zoom(order=1) off the last index."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-100, 300, size=src).astype(np.float32)
    want = np.asarray(jct._resize_linear_zoom(jnp.asarray(x), dst))
    got = ct._resize_linear_zoom(torch.from_numpy(x), dst).numpy()
    assert got.shape == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 300)
    scipy_ = ndi.zoom(x, [o / i for o, i in zip(dst, src)], order=1, grid_mode=False)
    np.testing.assert_allclose(got[:-1, :-1, :-1], scipy_[:-1, :-1, :-1], rtol=0, atol=1e-4 * 300)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("preserve_range", [True, False])
def test_resample_ct_matches_jax(order, preserve_range):
    rng = np.random.default_rng(6)
    vol = rng.uniform(-100, 300, size=(20, 24, 10)).astype(np.float32)
    for in_dim, out_dim in [((0.5, 0.5, 5.0), (-1, -1, 2.5)), ((0.7, 0.7, 3.0), (1.0, 1.0, 2.0))]:
        assert ct._resampled_shape(vol.shape, in_dim, out_dim) == \
            jct._resampled_shape(vol.shape, in_dim, out_dim)
        want = np.asarray(jct.resample_ct(jnp.asarray(vol), in_dim, out_dim,
                                          preserve_range=preserve_range, order=order))
        got = ct.resample_ct(torch.from_numpy(vol), in_dim, out_dim,
                             preserve_range=preserve_range, order=order).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 300)


def test_volume_metrics_match_jax():
    """iou_from_counts, volume_counts (index_add_ for segment_sum),
    volume_dice and dice_all_and_positive; counts exact, ratios within
    1e-7 relative."""
    rng = np.random.default_rng(7)
    tp, fp, fn = (rng.integers(0, 500, size=12).astype(np.float32) for _ in range(3))
    vids = np.asarray([0, 0, 2, 1, 1, 1, 2, 0, 3, 3, 2, 1], np.int32)
    has_ich = np.asarray([True, False, True, False])
    jt, jf, jn = (jnp.asarray(a) for a in (tp, fp, fn))
    tt, tf, tn = (torch.from_numpy(a) for a in (tp, fp, fn))
    np.testing.assert_allclose(metrics.iou_from_counts(tt, tf, tn).numpy(),
                               np.asarray(jmetrics.iou_from_counts(jt, jf, jn)), rtol=1e-7)
    want = jmetrics.volume_counts(jt, jf, jn, jnp.asarray(vids), 4)
    got = metrics.volume_counts(tt, tf, tn, torch.from_numpy(vids), 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vd = metrics.volume_dice(tt, tf, tn, torch.from_numpy(vids), 4)
    jvd = jmetrics.volume_dice(jt, jf, jn, jnp.asarray(vids), 4)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jvd), rtol=1e-7)
    for mask in (has_ich, np.zeros(4, bool)):
        got = metrics.dice_all_and_positive(vd, torch.from_numpy(mask))
        want = jmetrics.dice_all_and_positive(jvd, jnp.asarray(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
