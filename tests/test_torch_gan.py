"""The port's SN-PatchGAN trainer (ich_tpu_torch.train.gan) against
ich_tpu.train.gan, from the same flax-initialised weights carried by
``interop.from_jax`` and with the JAX step's masks injected.

Held: one train step's G, D and L1 losses at rtol 1e-4; every weight of
both nets within Adam's first-step bound (2 x 1.005 x lr: a gradient that
is float32 rounding moves its weight by up to lr in either package), and
99% of them within 1e-6. The step runs at lr 1e-5: a conv bias before a
BatchNorm has a zero gradient up to rounding, so Adam moves it by +-lr with
a sign that differs between the packages, and the G loss reads the updated
discriminator in eval mode, where that bias passes through (at lr 1e-3 the
G loss moves in its fourth digit); the spectral-norm u and sigma at atol 1e-5 and
the BatchNorm running statistics at atol 1e-4 after the step (D's moved
twice, G's once); the hinge losses at rtol 1e-6; the epoch plan equal to
JAX's; then the port alone: save / load, a resume bit-equal to a straight
run, and the inpaint composite."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ich_tpu.train.gan as jax_gan
from ich_tpu.models import PatchDiscriminator as JaxD
from ich_tpu.models import SAGatedGenerator as JaxG
from ich_tpu.ops import losses as JL
from ich_tpu.ops import masks as JM
from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.data.png import read_png_gray
from ich_tpu_torch.interop import from_jax as FJ
from ich_tpu_torch.models.inpainting import PatchDiscriminator, SAGatedGenerator
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.train import gan
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

MASK_KW = dict(n_draw=(1, 3), vertex=(2, 5), brush_width=(4, 8), length=(4, 10))
TRAIN = dict(batch_size=4, lr_g=1e-3, lr_d=1e-3, mask_kwargs=MASK_KW, seed=0)
D_KW = dict(out_channels=(8, 16, 16), kernel_size=3)


def _images(n=8, size=32, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, size, size)).astype(np.float32)


def _port_nets(seed=0):
    torch.manual_seed(seed)
    return SAGatedGenerator(lat_channels=4), PatchDiscriminator(**D_KW)


def _params(net):
    return torch.cat([p.detach().flatten() for p in net.parameters()])


def test_hinge_losses_match_jax():
    rng = np.random.default_rng(0)
    real, fake = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(float(L.hinge_d_loss(torch.from_numpy(real), torch.from_numpy(fake))),
                               float(JL.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(L.hinge_g_loss(torch.from_numpy(fake))),
                               float(JL.hinge_g_loss(jnp.asarray(fake))), rtol=1e-6)


def test_train_step_matches_jax_with_injected_masks():
    """One JAX step (jitted, masks from ``split(key)[0]``) against one port
    step with those masks: D step (G without gradient, stats discarded; D
    in train mode on real then fake), then G step through the updated D in
    eval mode, DiscountedL1 on coarse and fine."""
    images = _images()[:4]
    train = {**TRAIN, "lr_g": 1e-5, "lr_d": 1e-5}
    jt = jax_gan.SNPatchGAN(JaxG(lat_channels=4), JaxD(**D_KW), **train)
    jt._ensure_state((32, 32), 2)
    s = jt.state
    g_vars = jax.tree_util.tree_map(np.array, {"params": s.g_params, "batch_stats": s.g_stats})
    d_vars = jax.tree_util.tree_map(np.array, {"params": s.d_params, **s.d_stats})
    key = jax.random.PRNGKey(7)
    masks = np.array(JM.random_ff_masks(jax.random.split(key)[0], 4, (32, 32), **MASK_KW))
    assert 0.02 < masks.mean() < 0.6
    new, losses = jt._make_train_step()(s, jnp.asarray(images), key)
    jax_losses = [float(v) for v in losses]

    g, d = SAGatedGenerator(lat_channels=4), PatchDiscriminator(**D_KW)
    for net, sd in ((g, FJ.sa_gated_generator_state_dict_from_jax(g_vars)),
                    (d, FJ.patch_discriminator_state_dict_from_jax(d_vars))):
        net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    pt = gan.SNPatchGAN(g, d, device="cpu", **train)
    state = pt._train_state(2)
    g.train(), d.train()
    port_losses = [float(v) for v in pt._step(state, torch.from_numpy(images), None,
                                              masks=torch.from_numpy(masks))]
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert state.step == 1 and int(new.step) == 1

    want_g = FJ.sa_gated_generator_state_dict_from_jax(jax.tree_util.tree_map(
        np.array, {"params": new.g_params, "batch_stats": new.g_stats}))
    want_d = FJ.patch_discriminator_state_dict_from_jax(jax.tree_util.tree_map(
        np.array, {"params": new.d_params, **new.d_stats}))
    bound = 2 * 1.005 * 1e-5
    for net, want in ((g, want_g), (d, want_d)):
        sd = net.state_dict()
        names = [k for k, _ in net.named_parameters()]
        diff = torch.cat([(sd[k] - torch.from_numpy(np.array(want[k]))).abs().flatten()
                          for k in names])
        assert float(diff.max()) <= bound, float(diff.max())
        assert float((diff <= 1e-6).float().mean()) >= 0.99
        for k in want:
            if k.endswith((".u", ".sigma")):
                np.testing.assert_allclose(sd[k].numpy(), want[k], rtol=0, atol=1e-5)
            elif "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), want[k], rtol=0, atol=1e-4)


def test_epoch_plan_matches_jax(monkeypatch):
    """``n // batch_size`` shuffled batches a epoch, the last partial batch
    dropped, from one default_rng(seed + first epoch) created lazily: the
    JAX trainer's batches_fn, captured from its fit, against the port's."""
    captured = {}

    def fake_fit(state, step, batches_fn, n_epoch, **kw):
        captured["fn"] = batches_fn
        return state, [], 0.0

    monkeypatch.setattr(jax_gan, "fit", fake_fit)
    jt = jax_gan.SNPatchGAN(JaxG(lat_channels=4), JaxD(out_channels=(8,), kernel_size=3,
                                                       self_attention=False),
                            batch_size=3, seed=5)

    class _Data:
        images = np.zeros((11, 8, 8), np.float32)

    pt = gan.SNPatchGAN(*_port_nets(), batch_size=3, seed=5, device="cpu")
    for first in (0, 2):  # a straight run, and one resumed after two epochs
        jt.train(_Data())
        j_fn, p_fn = captured["fn"], pt.epoch_plan(11)
        for e in range(first, first + 3):
            j, p = [np.asarray(b) for b in j_fn(e)], p_fn(e)
            assert len(p) == 11 // 3
            np.testing.assert_array_equal(np.stack(p), np.stack(j))
    straight, resumed = pt.epoch_plan(11), pt.epoch_plan(11)
    [straight(e) for e in range(2)]
    assert not np.array_equal(np.stack(straight(2)), np.stack(resumed(2)))


def _gan(n_epoch, **kw):
    return gan.SNPatchGAN(*_port_nets(), n_epoch=n_epoch, device="cpu", **{**TRAIN, **kw})


def test_resume_equals_straight_run(tmp_path):
    """Two epochs, checkpointed after the first, resumed, against two
    straight epochs: histories and every weight, statistic, u and Adam
    moment bit-equal. The JAX plan shuffles a resumed run from
    default_rng(seed + 1), a straight one from default_rng(seed): with
    identical slices every plan gives the same batches."""
    data = LabeledSliceDataset(np.repeat(_images(1), 8, axis=0), np.zeros(8))
    path = str(tmp_path / "ckpt.bin")
    first = _gan(1, checkpoint_freq=1)
    first.train(data, checkpoint_path=path)
    resumed = _gan(2, checkpoint_freq=1)
    resumed.train(data, checkpoint_path=path)
    straight = _gan(2)
    straight.train(data)
    assert resumed.outputs["train"]["evolution"] == straight.outputs["train"]["evolution"]
    assert resumed.state.step == straight.state.step == 4
    a, b = resumed.state.state_dict(), straight.state.state_dict()
    for part in ("generator", "discriminator"):
        assert all(torch.equal(v, b["model"][part][k]) for k, v in a["model"][part].items())
        oa, ob = a["optimizer"][part]["state"], b["optimizer"][part]["state"]
        assert all(torch.equal(oa[i]["exp_avg_sq"], ob[i]["exp_avg_sq"]) for i in oa)
    assert not resumed.generator.training and not resumed.discriminator.training


def test_save_load_and_validate(tmp_path):
    data = LabeledSliceDataset(_images(), np.zeros(8))
    g = _gan(1)
    g.train(data, valid_dataset=data, valid_path=str(tmp_path / "valid"), valid_freq=1)
    png = read_png_gray(str(tmp_path / "valid" / "valid_ep1_0.png"))
    assert png.shape == (32, 96) and np.isfinite(g.outputs["eval"]["l1_valid"])
    g.save_model(str(tmp_path / "gan.bin"))
    g.save_outputs(str(tmp_path / "outputs.json"))
    with open(tmp_path / "outputs.json") as f:
        assert len(json.load(f)["train"]["evolution"]) == 1
    h = gan.SNPatchGAN(*_port_nets(seed=9), device="cpu")
    h.load_model(str(tmp_path / "gan.bin"), image_shape=(32, 32))
    m = np.zeros((2, 32, 32), np.float32)
    m[:, 8:20, 6:16] = 1
    np.testing.assert_array_equal(g.inpaint(data.images[:2], m), h.inpaint(data.images[:2], m))
    assert os.path.getsize(tmp_path / "gan.bin") > 0


def test_inpaint_composite_restores_mode():
    g = _gan(1)
    imgs = _images(2)
    m = np.zeros((2, 32, 32, 1), np.float32)
    m[:, 10:20, 10:20] = 1
    g.generator.train()
    out = g.inpaint(imgs, m)
    assert out.shape == (2, 32, 32, 1) and out.dtype == np.float32
    np.testing.assert_array_equal(out[..., 0] * (1 - m[..., 0]), imgs * (1 - m[..., 0]))
    with torch.no_grad():
        g.generator.eval()
        fine, _ = g.generator(torch.from_numpy(imgs[..., None]), torch.from_numpy(m))
    np.testing.assert_allclose(out[m > 0], fine.numpy()[m > 0], rtol=0, atol=1e-6)
    g.generator.train()
    g.inpaint(imgs, m)
    assert g.generator.training
    # a mirrored view (negative strides), as robust_anomaly_detect hands it
    np.testing.assert_array_equal(g.inpaint(np.flip(imgs, 2), np.flip(m, 2)),
                                  g.inpaint(np.flip(imgs, 2).copy(), np.flip(m, 2).copy()))


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gan.SNPatchGAN(*_port_nets())


def test_g_step_leaves_discriminator_gradients_alone():
    """The G step runs D in eval mode with its parameters out of autograd:
    D's gradients after a step are those of its own hinge loss, and the
    parameters require gradients again afterwards."""
    t = _gan(1)
    state = t._train_state(1)
    t.generator.train(), t.discriminator.train()
    snap = {}
    step = state.d_opt.step

    def recording_step(*a, **kw):
        snap["grads"] = [p.grad.clone() for p in t.discriminator.parameters()]
        return step(*a, **kw)

    state.d_opt.step = recording_step
    t._step(state, torch.from_numpy(_images(4)), prng_key(0))
    grads = [p.grad for p in t.discriminator.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(grads, snap["grads"]))
    assert all(p.requires_grad for p in t.discriminator.parameters())
    assert t.discriminator.training
