"""The draw sites of the port's GAN, FCDD and detector paths draw from one
jax.random key what the JAX package draws from it (the 3D transforms and
the device patch sampler are held in ``test_torch_transforms3d.py`` and
``test_torch_patch_sampler.py``):

- ``draw_ff_masks`` and ``draw_ellipse_params`` against the JAX package's
  draws replayed key by key (``test_torch_inpaint_ad._jax_draws``,
  ``test_torch_ae_fcdd.jax_ellipse_draws``): integers equal, floats within
  ``ULPS`` units in the last place; the masks and ellipse images rendered
  from a key ``array_equal`` to ``random_ff_masks`` / ``random_ff_mask`` and
  ``draw_ellipses_batch`` / ``draw_ellipses``;
- FCDD's step draws (``ka, kp = split(key)``: the ellipses and the uniforms
  that pick the corrupted slices) equal;
- the detector's W1 null sample for the first detection (``PRNGKey(seed)``
  itself) and a cleanup pass (``fold_in(., i + 1)``) within ``ULPS``, on
  the host and on the chunked large-draw path; ``detect`` with W1 and one
  inpainter gives every pass's distance map within 1e-5 relative and the
  same final mask;
- the 3D trainer's step: ``UNet2D``'s, its dropout keyed as flax keys it,
  a rank under a mesh drawing its rows of the global mask;
- the chip script's known answers for these draws (``chip_smoke.RNG_KNOWN``)
  recomputed with JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ich_tpu.train.inpaint_ad as jad
from ich_tpu.ops import masks as JM
from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG
from ich_tpu_torch.ops import masks as M
from ich_tpu_torch.train import inpaint_ad as ad
from ich_tpu_torch.train.fcdd_trainer import FCDD
from ich_tpu_torch.models.layers import Dropout, set_dropout_keys
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops.dropout import keyed_dropout
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.train.segmentation3d import UNet3D
from ich_tpu_torch.utils import rng
from tests.test_torch_ae_fcdd import ELLIPSES, jax_ellipse_draws
from tests.test_torch_inpaint_ad import CONFIG_MASK, _jax_draws

torch.set_num_threads(2)

ULPS = 4


def _ulps(a, b) -> int:
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _hold_draws(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert _ulps(g, w) <= ULPS, (k, _ulps(g, w))
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


MASK_CASES = {"config_96": ((96, 96), CONFIG_MASK),
              "wide_64x80": ((64, 80), dict(n_draw=(2, 6), vertex=(3, 9), brush_width=(4, 9))),
              "no_discs": ((48, 48), dict(n_salt_pepper=(0, 1)))}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_ff_mask_draws_and_render_equal_jax(case):
    shape, kw = MASK_CASES[case]
    for seed in (0, 42):
        key = jax.random.PRNGKey(seed)
        want = [_jax_draws(k, shape, **kw) for k in jax.random.split(key, 5)]
        got = M.draw_ff_masks(rng.prng_key(seed), 5, shape, **kw)
        _hold_draws(got, {k: np.stack([w[k] for w in want]) for k in want[0]})
        masks = M.random_ff_masks(rng.prng_key(seed), 5, shape, **kw).numpy()
        np.testing.assert_array_equal(masks, np.asarray(JM.random_ff_masks(key, 5, shape, **kw)))
        assert 0.0 < masks.mean() < 0.9
        np.testing.assert_array_equal(M.random_ff_mask(rng.prng_key(seed), shape, **kw).numpy(),
                                      np.asarray(JM.random_ff_mask(key, shape, **kw)))


ELLIPSE_CASES = {"defaults_64x48": ((64, 48), {}),
                 "fcdd_config_256": ((256, 256), dict(n_ellipse=(1, 10), major_axis=(1, 25),
                                                      minor_axis=(1, 25), intensity=(0.1, 1.0))),
                 "noise_40": ((40, 40), dict(noise=0.1, major_axis=(3, 12))),
                 "noise_past_the_host_path": ((96, 96), dict(noise=0.05))}


@pytest.mark.parametrize("case", sorted(ELLIPSE_CASES))
def test_ellipse_draws_and_render_equal_jax(case):
    """The last case's noise, 8 x 96^2 words, takes rng's large-draw path.
    Without noise the images are equal; with it, the ellipses cover the
    same pixels and the values are within ``ULPS`` (the noise's normals
    are, as ``tests/test_torch_rng.py`` holds them)."""
    shape, kw = ELLIPSE_CASES[case]
    b = 8
    for seed in (3, 42):
        key = jax.random.PRNGKey(seed)
        got = M.draw_ellipse_params(rng.prng_key(seed), b, shape, **kw)
        _hold_draws(got, {k: v.numpy() for k, v in jax_ellipse_draws(key, b, shape, **kw).items()})
        images = M.draw_ellipses_batch(rng.prng_key(seed), b, shape, **kw).numpy()
        want = np.asarray(JM.draw_ellipses_batch(key, b, shape, **kw))
        assert (want > 0).mean() > 0.002
        one = M.draw_ellipses(rng.prng_key(seed), shape, **kw).numpy()
        want_one = np.asarray(JM.draw_ellipses(key, shape, **kw))
        for got_img, want_img in ((images, want), (one, want_one)):
            if "noise" in kw:
                np.testing.assert_array_equal(got_img > 0, want_img > 0)
                assert _ulps(got_img, want_img) <= ULPS
            else:
                np.testing.assert_array_equal(got_img, want_img)
    assert b * shape[0] * shape[1] > rng.HOST_WORDS or case != "noise_past_the_host_path"


def test_fcdd_step_draws_equal_jax():
    """The ellipses and corruption uniforms of an FCDD step from its key,
    as the JAX step draws them, and the slices they corrupt."""
    t = FCDD(FCDD_CNN_VGG(), drawing_params=ELLIPSES, batch_size=8, device="cpu")
    labels = np.asarray([0, 1, 0, 0, 1, 0, 0, 0])
    for seed in (0, 11):
        key = jax.random.PRNGKey(seed)
        ka, kp = jax.random.split(key)
        ell, u = t.draw_anomalies(rng.prng_key(seed), 8, (32, 32))
        np.testing.assert_array_equal(ell.numpy(), np.asarray(
            JM.draw_ellipses_batch(ka, 8, (32, 32), **ELLIPSES)))
        want_u = np.asarray(jax.random.uniform(kp, (8,)))
        np.testing.assert_array_equal(u.numpy(), want_u)
        corrupt = (u.numpy() < t.anomaly_proba) & (labels == 0)
        np.testing.assert_array_equal(corrupt, (want_u < 0.5) & (labels == 0))


@pytest.mark.parametrize("shape", [(16, 32, 32), (8, 96, 96)], ids=["host", "large"])
def test_null_sample_equals_jax(shape):
    """``normal(key, shape)``: the first detection's key is ``PRNGKey(seed)``
    itself, cleanup pass i's ``fold_in(., i + 1)``."""
    det = ad.InpaintAnomalyDetector(lambda a, b: a, device="cpu", seed=3)
    key = jax.random.PRNGKey(3)
    for jk, pk in ((key, rng.prng_key(3)), (jax.random.fold_in(key, 2),
                                             rng.fold_in(rng.prng_key(3), 2))):
        got = det._null_normals(pk, shape)
        assert got.shape == shape and got.dtype == torch.float32
        assert _ulps(got.numpy(), np.asarray(jax.random.normal(jk, shape))) <= ULPS


FIELD = np.random.default_rng(21).normal(size=(32, 32)).astype(np.float32)


def test_detect_w1_follows_jax():
    """``detect`` with W1 on a synthetic slice, both packages inpainting
    with the same clean image plus a field weighted by each mask's area:
    every pass's distance map within 1e-5 relative (1e-6 absolute) and the
    final mask equal."""
    gen = np.random.default_rng(4)
    clean = gen.uniform(0.2, 0.4, size=(32, 32)).astype(np.float32)
    image = clean.copy()
    image[9:17, 11:20] = 0.9
    image[24:27, 4:9] = 0.65

    def fill(masks, xp):
        area = xp.asarray(np.asarray(masks, np.float32).reshape(len(masks), -1).sum(1) % 11 / 11)
        return xp.asarray(clean)[None, ..., None] + 0.03 * area[:, None, None, None] * xp.asarray(
            FIELD)[None, ..., None]

    def jax_fn(imgs, masks):
        return imgs * (1 - masks) + fill(masks, jnp) * masks

    def port_fn(imgs, masks):
        return imgs * (1 - masks) + fill(masks, np) * masks

    kw = dict(grid_hole=(8, 8), grid_step=4, batch_size=8, n_iter=3, early_stop=False,
              grid_anomaly_inpaint=((16, 16), (16, 16)), use_wasserstein=True, seed=5)
    maps = {"jax": [], "port": []}
    for name, cls, fn, extra in (("jax", jad.InpaintAnomalyDetector, jax_fn, {}),
                                 ("port", ad.InpaintAnomalyDetector, port_fn,
                                  {"device": "cpu"})):
        det = cls(fn, **kw, **extra)
        det._distance_map = _recorded(det._distance_map, maps[name])
        maps[name + "_mask"] = np.asarray(det.detect(image))
    assert len(maps["jax"]) == len(maps["port"]) == 1 + kw["n_iter"]
    for got, want in zip(maps["port"], maps["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(maps["port_mask"], maps["jax_mask"])
    assert maps["port_mask"][11:15, 13:18].all()


def _recorded(fn, out: list):
    """``fn`` that appends a float64 numpy copy of each result to ``out``."""
    def run(*args):
        d = fn(*args)
        out.append(np.asarray(d.cpu() if isinstance(d, torch.Tensor) else d, np.float64))
        return d

    return run


class _Mesh:
    def __init__(self, rank):
        self.rank = rank


def test_3d_step_is_the_2d_step_and_its_dropout_shards_the_stream():
    """``UNet3D`` runs ``UNet2D``'s step (``aug_key, drop_key =
    split(key)``); every Dropout takes ``drop_key`` and its own flax fold
    word, the same on a mesh, where rank r draws the stream from ``r``
    times its slice's size: rows ``r`` of the global batch's mask."""
    assert UNet3D._step is UNet2D._step
    net = UNet(depth=2, ndim=3, top_filter=4, norm="group", p_dropout=0.5).train()
    key = rng.prng_key(8)
    set_dropout_keys(net, key)
    drops = [m for m in net.modules() if isinstance(m, Dropout)]
    assert len(drops) == 2 and {m.key for m in drops} == {tuple(key.tolist())}
    assert len({m.fold for m in drops}) == 2
    set_dropout_keys(net, key, _Mesh(2))
    assert {m.key for m in drops} == {tuple(key.tolist())} and {m.shard for m in drops} == {2}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4, 2, 4, 4))
                         .astype(np.float32))
    whole = keyed_dropout(x, (*drops[0].key, drops[0].fold), 0.5)
    assert torch.equal(drops[0](x[4:6]), whole[4:6])
    assert not torch.equal(drops[0](x[4:6]), whole[0:2])
    set_dropout_keys(net, None)
    assert all(m.key is None for m in drops)
    # keyless, outside a step: a key from torch's generator, as nn.Dropout
    outs = []
    for _ in range(2):
        torch.manual_seed(3)
        outs.append(drops[0](x[4:6]))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], whole[4:6])


def test_the_chip_path_constants_are_jaxs():
    """``chip_smoke.py`` phase 15 holds the card's keyed path draws to these:
    recomputed here with JAX, they must equal what the script carries."""
    import chip_smoke as cs
    import json

    with open("configs/inpainting_gan.json") as f:
        assert cs.PATH_MASK_KW == json.load(f)["mask"]
    with open("configs/fcdd.json") as f:
        fcdd = json.load(f)
    assert cs.PATH_ELLIPSE_KW == fcdd["anomaly"]["drawing_params"]
    assert cs.PATH_FCDD == (fcdd["data"]["size"], fcdd["train"]["batch_size"])
    assert cs.PATH_NOISE_BATCH * cs.PATH_FCDD[0] ** 2 > rng.HOST_WORDS
    assert cs.RNG_KNOWN["paths"] == cs.path_answers(_jax_path_draws(cs))


def _jax_path_draws(cs) -> dict:
    """The draws phase 15 makes on the card, made by the JAX package."""
    from ich_tpu.data import patch_sampler as jps
    from ich_tpu.data.core import VolumeDataset3D as JaxVolumeDataset3D
    from ich_tpu.ops import transforms3d as JT3
    from ich_tpu.ops.warp import compose_affine

    key = jax.random.PRNGKey(cs.PATH_SEED)
    k_sampler, k_aug, k_mask, k_ell, k_noise = (jax.random.fold_in(key, i) for i in range(5))
    vols, masks = cs.sampler_stack()
    js = jps.DevicePatchSampler(JaxVolumeDataset3D(vols, masks, np.arange(len(vols))),
                                cs.PATH_PATCH, cs.PATH_POS_FRAC)
    n, psz = len(vols), jnp.asarray(cs.PATH_PATCH, jnp.int32)
    half = psz // 2

    def one(k):
        kv, kb, kp, ku = jax.random.split(k, 4)
        vi = jax.random.randint(kv, (), 0, n)
        lim = js._dims[vi] - psz
        cnt = js._pos_cnt[vi]
        use_pos = jnp.logical_and(jax.random.bernoulli(kb, js.pos_frac), cnt > 0)
        j = jax.random.randint(kp, (), 0, jnp.maximum(cnt, 1))
        start_pos = jnp.clip(js._pos_tab[vi, j] - half, 0, lim)
        start = jnp.where(use_pos, start_pos, jax.random.randint(ku, (3,), 0, lim + 1))
        return vi, start

    vi, start = jax.vmap(one)(jax.random.split(k_sampler, cs.PATH_SAMPLER_BATCH))
    aug = JT3.default_patch_augmentation()
    ka, kb = jax.random.split(k_aug, len(aug.transforms))
    affine = aug.transforms[0]
    kr, kh, kw = jax.random.split(ka, 3)
    b = cs.PATH_AUG_BATCH
    apply, factor = aug.transforms[1]._factors(kb, b)
    m, o = JT3._rotation_affine(kr, b, *affine.rotate)
    sy, sx = (jnp.where(jax.random.bernoulli(k, affine.p_flip, (b,)), -1.0, 1.0)
              for k in (kh, kw))
    zero = jnp.zeros((b,))
    m, _ = compose_affine(m, o, jnp.stack([jnp.stack([sy, zero], 1), jnp.stack([zero, sx], 1)],
                                          1), jnp.zeros((b, 2)))
    draws = {"sampler_vi": np.asarray(vi), "sampler_start": np.asarray(start),
             "aug_m": np.asarray(m), "aug_apply": np.asarray(apply),
             "aug_factor": np.asarray(factor)}
    size, gan_b = cs.PATH_GAN
    mask = [_jax_draws(k, (size, size), **cs.PATH_MASK_KW)
            for k in jax.random.split(k_mask, gan_b)]
    draws.update({"ff_" + k: np.stack([m[k] for m in mask]) for k in mask[0]})
    size, fcdd_b = cs.PATH_FCDD
    ell = jax_ellipse_draws(k_ell, fcdd_b, (size, size), **cs.PATH_ELLIPSE_KW)
    draws.update({"ell_" + k: v.numpy() for k, v in ell.items()})
    noise = jax_ellipse_draws(k_noise, cs.PATH_NOISE_BATCH, (size, size),
                              noise=cs.PATH_NOISE, **cs.PATH_ELLIPSE_KW)["noise"]
    draws["ell_noise"] = noise.numpy()
    null_key = jax.random.PRNGKey(cs.PATH_SEED)
    draws["null_first"] = np.asarray(jax.random.normal(null_key, cs.PATH_NULL_SHAPE))
    draws["null_cleanup"] = np.asarray(jax.random.normal(jax.random.fold_in(null_key, 1),
                                                         cs.PATH_NULL_SHAPE))
    return draws
