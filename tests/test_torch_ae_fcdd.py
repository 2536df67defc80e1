"""The port's AE and FCDD anomaly-detection routes against the JAX package's.

Held, with the same seeded numpy inputs and the flax-initialised weights
carried by ``interop.from_jax``:

- ``gdl_loss`` and ``hsc_loss`` (normal and anomaly labels, a score map of
  zeros among them) at rtol 1e-5;
- the ellipse render from JAX's draws (``jax.random`` replayed key by key):
  equal; the port's own draws from a key, JAX's (integers equal, floats
  within 4 ulp), and by their ranges;
- ``AENet`` with either decoder at 32^2: eval outputs at rtol 1e-5; train
  outputs within 1e-4 of the output's scale (flax's one-pass batch variance
  against torch's two-pass: float32 rounding that the small batch's
  BatchNorms amplify) and the running statistics at rtol 1e-5 (atol 1e-5
  of each vector's largest entry);
- ``FCDD_CNN_VGG`` at 32^2 at rtol 1e-5, ``receptive_field``, ``gkern`` at
  several sizes (equal) and ``receptive_upsample`` at several sizes at
  rtol 1e-5, and the transposed conv with a kernel that is not symmetric;
- one ``AE`` step (lambda 0 and 1) and one ``FCDD`` step (JAX's ellipses
  and corruption draws injected) against the jitted JAX steps: losses at
  rtol 1e-4; every weight within Adam's first-step bound (2 x 1.005 x lr:
  a gradient at float32's noise floor moves its weight by lr either way)
  and 98% within lr / 10; running statistics at atol 1e-4;
- ``anomaly_scores``, ``generate_heatmap``, ``get_min_max`` and
  ``grad_heatmap`` (``grad`` and ``xgrad``) of FCDD, and ``anomaly_map``
  of the AE, against the JAX trainers' at the tolerances stated there;
- the port alone: the lambda schedule (the GDL jump at the switch, as the
  JAX test holds it) and a resume past the switch bit-equal to a straight
  run, and FCDD's epoch AUC and localization PNGs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.models import AENet as JaxAENet
from ich_tpu.models import FCDD_CNN_VGG as JaxFCDDNet
from ich_tpu.models import fcdd as JF
from ich_tpu.ops import losses as JL
from ich_tpu.ops import masks as JM
from ich_tpu.train.ae_trainer import AE as JaxAE
from ich_tpu.train.fcdd_trainer import FCDD as JaxFCDD
from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.data.png import read_png_gray
from ich_tpu_torch.interop import from_jax as FJ
from ich_tpu_torch.models import fcdd as F
from ich_tpu_torch.models.ae import AENet
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.ops import masks as M
from ich_tpu_torch.train.ae_trainer import AE
from ich_tpu_torch.train.fcdd_trainer import FCDD
from ich_tpu_torch.utils.config import LOSSES, NETWORKS, TRAINERS
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

AE_KW = dict(latent_channels=4, bottleneck_channels=6, n_conv=2, kernel_size=5)
ELLIPSES = dict(n_ellipse=(1, 4), major_axis=(3, 10), minor_axis=(2, 8), intensity=(0.6, 1.0))
LR = 1e-3


def _images(n, size=32, seed=0, channels=False):
    x = np.random.default_rng(seed).uniform(size=(n, size, size)).astype(np.float32)
    return x[..., None] if channels else x


def _load(net, sd):
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return net


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# -- losses -------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_gdl_loss_matches_jax(reduction):
    rng = np.random.default_rng(1)
    im, rec = rng.normal(size=(2, 3, 12, 10, 2)).astype(np.float32)
    got = L.gdl_loss(torch.from_numpy(im), torch.from_numpy(rec), reduction).numpy()
    want = np.asarray(JL.gdl_loss(jnp.asarray(im), jnp.asarray(rec), reduction))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert LOSSES.build("GDL")(torch.from_numpy(im), torch.from_numpy(rec)).shape == ()


@pytest.mark.parametrize("labels", [(0, 0, 0, 0), (1, 1, 1, 1), (0, 1, 1, 0)])
def test_hsc_loss_matches_jax(labels):
    """Score maps of four samples, the last all zeros: its pseudo-Huber is
    0, so as an anomaly it takes -log(1e-31) = 71.4."""
    x = np.random.default_rng(2).normal(size=(4, 5, 5, 1)).astype(np.float32)
    x[-1] = 0.0
    y = np.asarray(labels, np.int32)
    for red in ("mean", "none"):
        got = L.hsc_loss(torch.from_numpy(x), torch.from_numpy(y), red).numpy()
        want = np.asarray(JL.hsc_loss(jnp.asarray(x), jnp.asarray(y), red))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if labels[-1] == 1:
        np.testing.assert_allclose(L.hsc_loss(torch.from_numpy(x), torch.from_numpy(y),
                                              "none")[-1].item(), -np.log(np.float32(1e-31)),
                                   rtol=1e-5)
    assert LOSSES.build("HSCLoss")(torch.from_numpy(x), torch.from_numpy(y)).shape == ()


# -- ellipses -----------------------------------------------------------------------


def jax_ellipse_draws(key, b, shape, n_ellipse=(1, 10), major_axis=(1, 25),
                      minor_axis=(1, 25), rotation=(0.0, 2 * np.pi), intensity=(0.1, 1.0),
                      noise=None):
    """The draws of ``ich_tpu.ops.masks.draw_ellipses_batch(key, b, shape)``,
    key by key, as the port's keys."""
    h, w = shape
    m = n_ellipse[1] - 1
    out = {k: [] for k in ("n", "cy", "cx", "major", "minor", "theta", "value", "noise")}
    for k in jax.random.split(key, b):
        kn, kc, kaxis, krot, kint, knoise = jax.random.split(k, 6)
        out["n"].append(jax.random.randint(kn, (), n_ellipse[0], n_ellipse[1]))
        out["cy"].append(jax.random.normal(kc, (m,)) * (h / 6.0) + h / 2.0)
        out["cx"].append(jax.random.normal(jax.random.fold_in(kc, 1), (m,)) * (w / 6.0)
                         + w / 2.0)
        maj = jax.random.uniform(kaxis, (m,), minval=float(major_axis[0]),
                                 maxval=float(major_axis[1]))
        out["major"].append(maj)
        out["minor"].append(jax.random.uniform(
            jax.random.fold_in(kaxis, 1), (m,), minval=float(minor_axis[0]),
            maxval=jnp.minimum(float(minor_axis[1]), maj)))
        out["theta"].append(jax.random.uniform(krot, (m,), minval=rotation[0],
                                               maxval=rotation[1]))
        out["value"].append(jax.random.uniform(kint, (m,), minval=intensity[0],
                                               maxval=intensity[1]))
        if noise is not None:
            out["noise"].append(jax.random.normal(knoise, (h, w)) * noise)
    return {k: torch.from_numpy(np.stack([np.asarray(a) for a in v])) for k, v in out.items()
            if v}


ELLIPSE_CASES = {"defaults_64x48": ((64, 48), {}),
                 "fcdd_config_256": ((256, 256), dict(n_ellipse=(1, 10), major_axis=(1, 25),
                                                      minor_axis=(1, 25),
                                                      intensity=(0.1, 1.0))),
                 "noise_40": ((40, 40), dict(noise=0.1, major_axis=(3, 12)))}


@pytest.mark.parametrize("case", sorted(ELLIPSE_CASES))
def test_ellipse_render_from_jax_draws_is_equal(case):
    shape, kw = ELLIPSE_CASES[case]
    key = jax.random.PRNGKey(3)
    want = np.asarray(JM.draw_ellipses_batch(key, 6, shape, **kw))
    got = M.render_ellipses(jax_ellipse_draws(key, 6, shape, **kw), shape).numpy()
    assert (want > 0).mean() > 0.005
    np.testing.assert_array_equal(got, want)


def test_ellipse_draws_follow_the_jax_distributions():
    d = M.draw_ellipse_params(prng_key(0), 2000, (64, 32), **ELLIPSES)
    assert d["cy"].shape == (2000, 3) and set(d["n"].unique().tolist()) == {1, 2, 3}
    assert (d["major"] >= 3).all() and (d["major"] < 10).all()
    assert (d["minor"] >= 2).all() and (d["minor"] <= d["major"]).all()
    assert (d["value"] >= 0.6).all() and (d["value"] < 1.0).all()
    assert abs(float(d["cy"].mean()) - 32) < 0.5 and abs(float(d["cx"].std()) - 32 / 6) < 0.2
    one = M.draw_ellipses(prng_key(5), (32, 32), noise=0.05)
    again = M.draw_ellipses(prng_key(5), (32, 32), noise=0.05)
    batch = M.draw_ellipses_batch(prng_key(5), 2, (32, 32), noise=0.05)
    assert torch.equal(one, again) and one.shape == (32, 32) and float(one.max()) <= 1.0
    np.testing.assert_array_equal(one.numpy(), np.asarray(JM.draw_ellipses(
        jax.random.PRNGKey(5), (32, 32), noise=0.05)))
    assert batch.shape == (2, 32, 32) and not torch.equal(batch[0], batch[1])


# -- networks -----------------------------------------------------------------------


@pytest.mark.parametrize("bilinear", [False, True])
def test_aenet_matches_flax(bilinear):
    x = _images(4, channels=True)
    kw = dict(AE_KW, bilinear=bilinear)
    jn = JaxAENet(**kw)
    v = jax.tree_util.tree_map(np.array, dict(jn.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    sd = FJ.ae_state_dict_from_jax(v)
    net = AENet(**kw)
    assert set(sd) == set(net.state_dict())
    _load(net, sd)
    (want, want_z) = jn.apply(v, jnp.asarray(x), return_bottleneck=True)
    got, got_z = net.eval()(_nchw(x), return_bottleneck=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(got_z), np.asarray(want_z), rtol=1e-5, atol=1e-6)
    want_t, mut = jn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got_t = _nhwc(net.train()(_nchw(x)))
    want_t = np.asarray(want_t)
    assert np.abs(got_t - want_t).max() <= 1e-4 * np.abs(want_t).max()
    stats = FJ.ae_state_dict_from_jax({"params": v["params"], "batch_stats": jax.tree_util.
                                       tree_map(np.array, mut["batch_stats"])})
    for k, a in stats.items():
        if "running" in k:
            np.testing.assert_allclose(net.state_dict()[k].numpy(), a, rtol=1e-5,
                                       atol=1e-5 * np.abs(a).max(), err_msg=k)
    built = NETWORKS.build("AE_net", latent_channels=4, bottelneck_channels=6, n_conv=2,
                           bilinear=bilinear)
    assert built.encoder.bottelneck_conv[0].out_channels == 6


def test_fcdd_net_matches_flax():
    x = _images(3, channels=True, seed=1)
    jn = JaxFCDDNet()
    v = jax.tree_util.tree_map(np.array, dict(jn.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    sd = FJ.fcdd_state_dict_from_jax(v)
    net = F.FCDD_CNN_VGG()
    assert set(sd) == set(net.state_dict())
    _load(net, sd).eval()
    want = np.asarray(jn.apply(v, jnp.asarray(x)))
    got = _nhwc(net(_nchw(x)))
    assert got.shape == (3, 4, 4, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    feats = net(_nchw(x), ad=False)
    np.testing.assert_allclose(_nhwc(feats), np.asarray(jn.apply(v, jnp.asarray(x), ad=False)),
                               rtol=1e-5, atol=1e-6)
    assert isinstance(NETWORKS.build("FCDD_CNN_VGG", in_shape=(1, 32, 32)), F.FCDD_CNN_VGG)


@pytest.mark.parametrize("k", [3, 5, 6, 31, 32, 62])
def test_gkern_matches_jax(k):
    assert F.kernel_size_to_std(k) == JF.kernel_size_to_std(k)
    np.testing.assert_array_equal(F.gkern(k).numpy(), np.asarray(JF.gkern(k)))
    np.testing.assert_array_equal(F.gkern(k, 8.0).numpy(), np.asarray(JF.gkern(k, 8.0)))


@pytest.mark.parametrize("side", [32, 64, 256])
@pytest.mark.parametrize("std", [None, 8.0])
def test_receptive_upsample_matches_jax(side, std):
    assert F.receptive_field() == JF.receptive_field() == (62, 8, 3.5)
    s = np.random.default_rng(side).normal(size=(2, side // 8, side // 8, 1)).astype(np.float32)
    want = np.asarray(JF.receptive_upsample(jnp.asarray(s), (side, side), std=std))
    got = _nhwc(F.receptive_upsample(_nchw(s), (side, side), std=std))
    assert got.shape == (2, side, side, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    heat = F.FCDD_CNN_VGG.heatmap(_nchw(s), (side, side), std=std)
    np.testing.assert_allclose(_nhwc(heat), np.asarray(JaxFCDDNet.heatmap(
        jnp.asarray(s), (side, side), std=std)), rtol=1e-5, atol=1e-7)


def test_transposed_conv_is_set_up_as_lax_for_a_kernel_that_is_not_symmetric():
    """``lax.conv_transpose`` does not flip its kernel and torch's does: the
    port flips it back, which only a kernel without symmetry shows."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 4, 1)).astype(np.float32)
    kern = rng.normal(size=(7, 6)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(kern).reshape(7, 6, 1, 1), strides=(3, 3),
        padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = _nhwc(F.conv_transpose_lax(_nchw(x), torch.from_numpy(kern), 3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    flipped = _nhwc(torch.nn.functional.conv_transpose2d(
        _nchw(x), torch.from_numpy(kern)[None, None], stride=3))
    assert np.abs(flipped - want).max() > 0.1  # torch's own convention differs


# -- trainers: one step against the jitted JAX step -----------------------------------


def _copy(state):
    return jax.tree_util.tree_map(jnp.array, state)


def _hold_weights(net, want_sd, lr):
    """Every parameter within Adam's first-step bound, 98% within lr / 10;
    running statistics at atol 1e-4."""
    sd = net.state_dict()
    names = [k for k, _ in net.named_parameters()]
    diff = torch.cat([(sd[k] - torch.from_numpy(np.array(want_sd[k]))).abs().flatten()
                      for k in names])
    assert float(diff.max()) <= 2 * 1.005 * lr, float(diff.max())
    assert float((diff <= lr / 10).float().mean()) >= 0.98
    for k, a in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), a, rtol=0, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def jax_ae():
    """A JAX AE trainer, its fresh state and its jitted step."""
    jt = JaxAE(JaxAENet(**AE_KW), lambda_GDL={"0": 0.0}, batch_size=4, lr=LR, seed=0)
    jt._ensure_state((32, 32), 2)
    return jt, _copy(jt.state), jt._make_train_step()


def _port_ae(variables, **kw):
    net = _load(AENet(**AE_KW), FJ.ae_state_dict_from_jax(variables))
    return AE(net, device="cpu", batch_size=4, lr=LR, seed=0, **kw)


@pytest.mark.parametrize("lam", [0.0, 1.0])
def test_ae_step_matches_jax(jax_ae, lam):
    jt, s0, step = jax_ae
    v0 = jax.tree_util.tree_map(np.array, {"params": s0.params, "batch_stats": s0.batch_stats})
    x = _images(4, seed=3)
    new, loss = step(_copy(s0), jnp.asarray(x), jax.random.PRNGKey(1), lam)
    pt = _port_ae(v0)
    pt.lambda_gdl = lam
    state = pt._train_state(2)
    pt.net.train()
    got = float(pt._step(state, torch.from_numpy(x), prng_key(1)))
    np.testing.assert_allclose(got, float(loss), rtol=1e-4)
    if lam:
        assert got > 10  # the GDL, a sum over each slice's pixels, dominates L1 + L2
    want = FJ.ae_state_dict_from_jax(jax.tree_util.tree_map(
        np.array, {"params": new.params, "batch_stats": new.batch_stats}))
    _hold_weights(pt.net, want, LR)


def test_ae_anomaly_map_matches_jax(jax_ae):
    jt, s0, _ = jax_ae
    jt.state = _copy(s0)
    v0 = jax.tree_util.tree_map(np.array, {"params": s0.params, "batch_stats": s0.batch_stats})
    x = _images(6, seed=4)
    pt = _port_ae(v0, n_epoch=1)
    got, want = pt.anomaly_map(x), jt.anomaly_map(x)
    assert got.shape == (6, 32, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt.validate(LabeledSliceDataset(x, np.zeros(6))),
                               jt.validate(LabeledSliceDataset(x, np.zeros(6))), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_fcdd():
    """A JAX FCDD trainer (config-style ellipses), its fresh state and its
    jitted step."""
    jt = JaxFCDD(JaxFCDDNet(), anomaly_proba=0.5, drawing_params=ELLIPSES, gauss_std=8.0,
                 batch_size=4, lr=LR, seed=0)
    jt._ensure_state((32, 32), 2)
    return jt, _copy(jt.state), jt._make_train_step()


def _port_fcdd(variables, **kw):
    net = _load(F.FCDD_CNN_VGG(), FJ.fcdd_state_dict_from_jax(variables))
    return FCDD(net, anomaly_proba=0.5, drawing_params=ELLIPSES, gauss_std=8.0, device="cpu",
                batch_size=4, lr=LR, seed=0, **kw)


def test_fcdd_step_matches_jax_with_injected_ellipses(jax_fcdd):
    jt, s0, step = jax_fcdd
    v0 = jax.tree_util.tree_map(np.array, {"params": s0.params, "batch_stats": s0.batch_stats})
    x = _images(4, seed=5)
    labels = np.asarray([0, 0, 1, 0], np.int32)
    key = jax.random.PRNGKey(11)
    ka, kp = jax.random.split(key)
    draws = jax_ellipse_draws(ka, 4, (32, 32), **ELLIPSES)
    u = torch.from_numpy(np.array(jax.random.uniform(kp, (4,))))
    corrupt = (u.numpy() < 0.5) & (labels == 0)
    assert corrupt.any() and not corrupt.all()
    new, loss = step(_copy(s0), jnp.asarray(x), jnp.asarray(labels), key)
    pt = _port_fcdd(v0)
    state = pt._train_state(2)
    pt.net.train()
    got = float(pt._step(state, torch.from_numpy(x), torch.from_numpy(labels), None,
                         ellipses=M.render_ellipses(draws, (32, 32)), u=u))
    np.testing.assert_allclose(got, float(loss), rtol=1e-4)
    # the same step drawing from the key itself
    pt = _port_fcdd(v0)
    state = pt._train_state(2)
    pt.net.train()
    got = float(pt._step(state, torch.from_numpy(x), torch.from_numpy(labels), prng_key(11)))
    np.testing.assert_allclose(got, float(loss), rtol=1e-4)
    want = FJ.fcdd_state_dict_from_jax(jax.tree_util.tree_map(
        np.array, {"params": new.params, "batch_stats": new.batch_stats}))
    _hold_weights(pt.net, want, LR)


def test_fcdd_scoring_matches_jax(jax_fcdd):
    """anomaly_scores and heatmaps at rtol 1e-5 (atol 1e-6 of the scale),
    the quantile range at rtol 1e-5; the input gradients (the VGG stack's
    backward) within 1e-4 of their scale."""
    jt, s0, _ = jax_fcdd
    jt.state = _copy(s0)
    v0 = jax.tree_util.tree_map(np.array, {"params": s0.params, "batch_stats": s0.batch_stats})
    # non-trivial running statistics, so that eval mode is not the identity
    rng = np.random.default_rng(0)
    v0["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v0["batch_stats"])
    jt.state = jt.state.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                   v0["batch_stats"]))
    pt = _port_fcdd(v0)
    x = _images(6, seed=6)
    np.testing.assert_allclose(pt.anomaly_scores(x), jt.anomaly_scores(x), rtol=1e-5)
    raw_w, raw_g = jt.generate_heatmap(x, scale=False), pt.generate_heatmap(x, scale=False)
    assert raw_g.shape == (6, 32, 32)
    np.testing.assert_allclose(raw_g, raw_w, rtol=1e-5, atol=1e-6 * np.abs(raw_w).max())
    np.testing.assert_allclose(pt.get_min_max(x), jt.get_min_max(x), rtol=1e-5)
    np.testing.assert_allclose(pt.generate_heatmap(x), jt.generate_heatmap(x), rtol=1e-5,
                               atol=1e-5)
    for method in ("grad", "xgrad"):
        for absolute in (True, False):
            want = jt.grad_heatmap(x, method, absolute)
            got = pt.grad_heatmap(x, method, absolute)
            assert got.shape == (6, 32, 32)
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), (method, absolute)
    with pytest.raises(ValueError):
        pt.grad_heatmap(x, "nope")


# -- the port alone -----------------------------------------------------------------------


def _ae_run(n_epoch, tmp_path=None, lam=None):
    torch.manual_seed(0)
    net = AENet(latent_channels=4, bottleneck_channels=4, n_conv=2, kernel_size=3)
    ae = AE(net, lambda_GDL=lam or {"2": 0.5}, n_epoch=n_epoch, batch_size=8, lr=1e-3,
            device="cpu", seed=0)
    data = LabeledSliceDataset(_images(20, seed=7), np.zeros(20))
    ae.train(data, checkpoint_path=None if tmp_path is None else str(tmp_path / "ckpt.bin"))
    return ae


def test_lambda_schedule_switches_on_and_survives_a_resume(tmp_path):
    """The GDL term dominates from its scheduled epoch (the JAX test's
    ``hist[2] > 10 * hist[1]``); a run stopped after the switch and resumed
    replays the weight and ends bit-equal to the straight run."""
    straight = _ae_run(4)
    hist = straight.outputs["train"]["evolution"]
    assert [r[0] for r in hist] == [1, 2, 3, 4] and hist[2][1] > 10 * hist[1][1]
    assert straight.lambda_at(0) == 0.0 and straight.lambda_at(5) == 0.5
    _ae_run(3, tmp_path)
    resumed = _ae_run(4, tmp_path)
    assert resumed.outputs["train"]["evolution"] == hist
    assert resumed.lambda_gdl == 0.5
    for k, v in straight.net.state_dict().items():
        assert torch.equal(v, resumed.net.state_dict()[k]), k
    amap = straight.anomaly_map(_images(3, seed=8))
    assert amap.shape == (3, 32, 32) and (amap >= 0).all()
    assert TRAINERS.get("AE") is AE and TRAINERS.get("FCDD") is FCDD


def test_ae_validate_writes_reconstruction_pngs(tmp_path):
    ae = _ae_run(1)
    l1 = ae.validate(LabeledSliceDataset(_images(10, seed=9), np.zeros(10)),
                     save_path=str(tmp_path), epoch=5)
    assert np.isfinite(l1) and ae.outputs["eval"]["l1_valid"] == l1
    png = read_png_gray(str(tmp_path / "rec_ep5_7.png"))
    assert png.shape == (32, 64) and not (tmp_path / "rec_ep5_8.png").exists()


def test_fcdd_trains_validates_and_localizes(tmp_path):
    ims = _images(16, seed=10)
    labels = np.zeros((16, 7), np.float32)
    labels[:4, 0] = 1
    torch.manual_seed(0)
    f = FCDD(F.FCDD_CNN_VGG(), drawing_params=ELLIPSES, gauss_std=8.0, n_epoch=2,
             batch_size=4, lr=1e-4, device="cpu", seed=0)
    data = LabeledSliceDataset(ims, labels)
    f.train(data, valid_dataset=data, checkpoint_path=str(tmp_path / "ckpt.bin"))
    hist = f.outputs["train"]["evolution"]
    assert len(hist) == 2 and all(np.isfinite(r[1]) and 0 <= r[2] <= 1 for r in hist)
    assert f.outputs["eval"]["auc"] == hist[-1][2]
    lo, hi = f.get_min_max(ims)
    assert lo < hi
    f.localize_anomalies(ims, str(tmp_path / "loc"), n=3)
    png = read_png_gray(str(tmp_path / "loc" / "anomaly_2.png"))
    assert png.shape == (32, 64) and not (tmp_path / "loc" / "anomaly_3.png").exists()
