"""The port's 3D patch samplers against the JAX package's: the host sampler
``sample_patches`` bit for bit for the same ``np.random.Generator``; the
device sampler's stack and positive-voxel tables equal, its draws from a
key the JAX sampler's (the same volumes and starts, so equal patches), its
patches equal numpy slices for hand-made draws, and its draws held by
their properties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.data import patch_sampler as jps
from ich_tpu.data.core import VolumeDataset3D as JaxVolumeDataset3D
from ich_tpu.train.segmentation3d import sample_patches as jax_sample_patches
from ich_tpu_torch.data import patch_sampler as ps
from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.train.segmentation3d import _pad_to, sample_patches
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

PATCH = (8, 16, 16)
# short along D, along H and W, along all three, and one without a bleed
SHAPES = [(20, 24, 24), (5, 24, 20), (12, 10, 12), (6, 9, 11), (16, 16, 16)]


def _dataset(seed=0, empty=(4,), graded=False):
    rng = np.random.default_rng(seed)
    vols, masks = [], []
    for i, s in enumerate(SHAPES):
        vols.append(rng.uniform(size=s).astype(np.float32))
        m = (rng.uniform(size=s) > 0.9).astype(np.float32)
        if i in empty:
            m[:] = 0
        if graded and i == 0:
            m[m > 0] = rng.choice([1.0, 2.0], size=int((m > 0).sum()))
        masks.append(m)
    ids = np.arange(10, 10 + len(SHAPES))
    return VolumeDataset3D(vols, masks, ids), JaxVolumeDataset3D(vols, masks, ids)


@pytest.mark.parametrize("pos_frac", [0.0, 0.5, 1.0])
def test_sample_patches_matches_jax(pos_frac):
    """Four batches from one generator (the positive-voxel cache fills on
    the way): images and masks ``np.array_equal``."""
    port, jax_ds = _dataset()
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        got = sample_patches(rng_p, port, 6, PATCH, pos_frac)
        want = jax_sample_patches(rng_j, jax_ds, 6, PATCH, pos_frac)
        for g, w in zip(got, want):
            assert g.shape == (6,) + PATCH and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert sorted(port._pos_cache) == sorted(jax_ds._pos_cache)
    if pos_frac == 1.0:
        assert sorted(port._pos_cache) == [0, 1, 2, 3]


def test_device_sampler_tables_match_jax():
    """The padded stack, ``dims``, the positive-voxel table (subsampled to
    ``max_pos`` from ``default_rng(seed_pad)``) and its counts equal the
    JAX sampler's, and so do ``hbm_bytes`` and ``estimate_hbm_bytes``."""
    port, jax_ds = _dataset()
    got = ps.DevicePatchSampler(port, PATCH, max_pos=40, seed_pad=5, device="cpu")
    want = jps.DevicePatchSampler(jax_ds, PATCH, max_pos=40, seed_pad=5)
    for name in ("vols", "msks", "dims", "pos_tab", "pos_cnt"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, "_" + name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.pos_cnt.tolist() == [40, 40, 40, 40, 0]
    assert got.hbm_bytes == want.hbm_bytes
    for max_pos in (40, 16384):
        assert (ps.estimate_hbm_bytes(port, PATCH, max_pos)
                == jps.estimate_hbm_bytes(jax_ds, PATCH, max_pos))
    assert ps.estimate_hbm_bytes(port, PATCH, 40) == got.hbm_bytes


def _reference_starts(s, draws):
    """The starts from the (B, 6) draws in numpy, with the JAX sampler's
    rules."""
    dims, tab = s.dims.numpy(), s.pos_tab.numpy()
    patch = np.asarray(s.patch)
    vi, use_pos, j = draws[:, 0], draws[:, 1].astype(bool), draws[:, 2]
    lim = dims[vi] - patch
    start_pos = np.clip(tab[vi, j] - patch // 2, 0, lim)
    return vi, np.where(use_pos[:, None], start_pos, draws[:, 3:])


def test_injected_draws_give_numpy_slices():
    """Hand-made draws (every volume, both branches, the first and last
    table entries, the least and greatest uniform starts): the starts equal
    the numpy rules, and each patch and mask equals the numpy slice of its
    padded volume."""
    port, _ = _dataset()
    s = ps.DevicePatchSampler(port, PATCH, pos_frac=0.5, device="cpu")
    b, n = 24, len(SHAPES)
    rng = np.random.default_rng(9)
    cnt = s.pos_cnt.numpy()
    lim = s.dims.numpy() - np.asarray(PATCH)
    vi = np.arange(b) % n
    use_pos = (np.arange(b) // n) % 2 == 0
    use_pos &= cnt[vi] > 0  # as ``draw`` leaves it
    j = np.where(np.arange(b) < b // 2, 0, np.maximum(cnt[vi] - 1, 0))
    start_uni = (rng.uniform(size=(b, 3)) * (lim[vi] + 1)).astype(np.int64)
    start_uni[-4:-2] = 0
    start_uni[-2:] = lim[vi[-2:]]
    draws = np.concatenate([np.stack([vi, use_pos, j], 1).astype(np.int64), start_uni], 1)
    got_vi, start = s.starts(torch.from_numpy(draws))
    want_vi, want_start = _reference_starts(s, draws)
    np.testing.assert_array_equal(got_vi.numpy(), want_vi)
    np.testing.assert_array_equal(start.numpy(), want_start)
    imgs, msks = s.gather(got_vi, start)
    assert imgs.dtype == msks.dtype == torch.float32 and imgs.shape == (b,) + PATCH
    for k in range(b):
        sl = tuple(slice(a, a + p) for a, p in zip(want_start[k], PATCH))
        v = int(want_vi[k])
        np.testing.assert_array_equal(imgs[k].numpy(), _pad_to(port.volumes[v], PATCH)[sl])
        np.testing.assert_array_equal(msks[k].numpy(),
                                      (_pad_to(port.masks[v], PATCH)[sl] > 0).astype(np.float32))


def _jax_draws(js, key, b):
    """(vi, use_pos, j, start_uni) of the JAX sampler's ``_sample_batch``
    from ``key``, its key tree replayed per sample."""
    n, psz = js._vols.shape[0], jnp.asarray(js.patch, jnp.int32)

    def one(k):
        kv, kb, kp, ku = jax.random.split(k, 4)
        vi = jax.random.randint(kv, (), 0, n)
        cnt = js._pos_cnt[vi]
        use_pos = jnp.logical_and(jax.random.bernoulli(kb, js.pos_frac), cnt > 0)
        j = jax.random.randint(kp, (), 0, jnp.maximum(cnt, 1))
        return vi, use_pos, j, jax.random.randint(ku, (3,), 0, js._dims[vi] - psz + 1)

    return [np.asarray(a) for a in jax.vmap(one)(jax.random.split(key, b))]


@pytest.mark.parametrize("pos_frac", [0.0, 0.5, 1.0])
def test_draws_from_a_key_equal_jax(pos_frac):
    """From one key the port draws the JAX sampler's volumes, branches,
    table entries and uniform starts (integers equal), and so gathers the
    JAX sampler's patches and masks, equal."""
    port, jax_ds = _dataset()
    s = ps.DevicePatchSampler(port, PATCH, pos_frac=pos_frac, max_pos=40, device="cpu")
    js = jps.DevicePatchSampler(jax_ds, PATCH, pos_frac=pos_frac, max_pos=40)
    for seed in (0, 7):
        draws = s.draw(prng_key(seed), 16).numpy()
        vi, use_pos, j, start_uni = _jax_draws(js, jax.random.PRNGKey(seed), 16)
        np.testing.assert_array_equal(draws[:, 0], vi)
        np.testing.assert_array_equal(draws[:, 1], use_pos)
        np.testing.assert_array_equal(draws[:, 2], j)
        np.testing.assert_array_equal(draws[:, 3:], start_uni)
        want = js(jax.random.PRNGKey(seed), 16)
        got = s(prng_key(seed), 16)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_draws_stay_in_bounds_and_uniform_starts_are_exact():
    """Drawn batches: starts in [0, lim] of their own volume (short
    volumes padded up to the patch have lim 0), every volume drawn, every
    uniform start 0..12 along D of the 20-deep volume drawn and none
    beyond; ``pos_frac=1`` patches always hold a bleed when their volume
    has one."""
    port, _ = _dataset()
    s = ps.DevicePatchSampler(port, PATCH, pos_frac=0.0, device="cpu")
    seen = {}
    for i in range(40):
        vi, start = s.starts(s.draw(prng_key(i), 64))
        lim = s.dims[vi] - torch.as_tensor(PATCH)
        assert bool(((start >= 0) & (start <= lim)).all())
        for v, st in zip(vi.tolist(), start.tolist()):
            seen.setdefault(v, set()).add(tuple(st))
    assert set(seen) == set(range(len(SHAPES)))
    d_starts = {st[0] for st in seen[0]}
    assert d_starts == set(range(20 - 8 + 1))  # 0..12 all drawn, 13 never
    s1 = ps.DevicePatchSampler(port, PATCH, pos_frac=1.0, device="cpu")
    for i in range(10):
        vi, start = s1.starts(s1.draw(prng_key(100 + i), 32))
        _, msks = s1.gather(vi, start)
        has = msks.flatten(1).amax(dim=1) > 0
        assert bool(has[vi != 4].all())


def test_non_binary_masks_raise():
    port, _ = _dataset(graded=True)
    assert not ps.is_binary_mask(port.masks[0]) and ps.is_binary_mask(port.masks[1])
    assert ps.is_binary_mask(port.masks[1] * 255) and ps.is_binary_mask(np.zeros((2, 2)))
    with pytest.raises(ValueError, match="binary masks"):
        ps.DevicePatchSampler(port, PATCH, device="cpu")


def test_same_generator_same_batch():
    port, _ = _dataset()
    s = ps.DevicePatchSampler(port, PATCH, device="cpu")
    a = s(prng_key(4), 8)
    b = s(prng_key(4), 8)
    c = s(prng_key(5), 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
