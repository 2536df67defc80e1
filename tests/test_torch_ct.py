"""The port's CT ops and metrics against the JAX package on the same
numpy-seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
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
