"""The keyed steps of the 3D, GAN and FCDD trainers follow the JAX
package's from one seed: both packages build their nets fresh from the
seed (the port's ``key=`` init is flax's, ``tests/test_torch_init.py``) and
draw every patch, augmentation, mask and ellipse from the same keys, so
on the CPU

- ``UNet3D.train`` (GroupNorm, dropout 0 as ``configs/unet3d.json``,
  ``default_patch_augmentation``) gives the JAX trainer's first 10 losses
  within rtol 1e-4, with the device sampler (``ks, key = split(key)``)
  and with the host sampler (the key left whole);
- three ``SNPatchGAN`` steps draw the JAX step's masks (equal) and give its
  G, D and L1 losses within rtol 1e-4, at lr 1e-5 as
  ``test_torch_gan.py`` explains (at lr 1e-3 Adam's sign flips on the
  rounding-noise gradients of the biases before a BatchNorm move the G
  loss in its fourth digit);
- ten ``FCDD`` steps (the ellipses and the corruption flags drawn each
  step) give the JAX trainer's losses within rtol 1e-4, at lr 1e-5 for
  the GAN's reason: with no draw at all (``artificial_anomaly`` off) the
  two packages' losses part by up to 1.8e-3 over ten steps at lr 1e-4 and
  5.6e-3 at lr 1e-3, the VGG stack's BatchNorm biases taking Adam's sign
  flips; at lr 1e-5 with the draws they stay within 6e-6."""

import jax
import numpy as np
import pytest
import torch

from ich_tpu.data.core import LabeledSliceDataset as JaxLabeledSliceDataset
from ich_tpu.data.core import VolumeDataset3D as JaxVolumeDataset3D
from ich_tpu.models import FCDD_CNN_VGG as JaxFCDDNet
from ich_tpu.models import PatchDiscriminator as JaxD
from ich_tpu.models import SAGatedGenerator as JaxG
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops import masks as JM
from ich_tpu.ops import transforms3d as JT3
from ich_tpu.train.fcdd_trainer import FCDD as JaxFCDD
from ich_tpu.train.gan import SNPatchGAN as JaxSNPatchGAN
from ich_tpu.train.segmentation3d import UNet3D as JaxUNet3D
from ich_tpu_torch.data.core import LabeledSliceDataset, VolumeDataset3D
from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG
from ich_tpu_torch.models.inpainting import PatchDiscriminator, SAGatedGenerator
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import transforms3d as T3
from ich_tpu_torch.train import gan
from ich_tpu_torch.train.fcdd_trainer import FCDD
from ich_tpu_torch.train.segmentation3d import UNet3D
from ich_tpu_torch.utils import rng
from tests.test_torch_trainer3d import _volumes

torch.set_num_threads(2)

SEED = 5


def _record_jax(trainer, out: list, keys: list = None):
    """Each loss (tuple of losses) of the JAX trainer's jitted step, and
    optionally each step's key."""
    make = trainer._make_train_step

    def make_recording():
        step = make()

        def run(state, *args):
            state, loss = step(state, *args)
            out.append(np.asarray(loss).tolist() if np.ndim(loss) == 0
                       else [float(v) for v in loss])
            if keys is not None:
                keys.append(args[-1])
            return state, loss

        return run

    trainer._make_train_step = make_recording


def _record_port(trainer, name: str, out: list):
    """Each loss (tuple of losses) that the port trainer's ``name`` method
    returns."""
    fn = getattr(trainer, name)

    def run(*args, **kw):
        loss = fn(*args, **kw)
        out.append(float(loss) if isinstance(loss, torch.Tensor)
                   else [float(v) for v in loss])
        return loss

    setattr(trainer, name, run)


NET3D = dict(depth=3, ndim=3, top_filter=4, midchannels_factor=1, norm="group", p_dropout=0.0)


@pytest.mark.parametrize("device_sampler", [True, False], ids=["device", "host"])
def test_unet3d_train_follows_jax(device_sampler):
    vols, masks = _volumes(1)
    ids = np.asarray([3, 7, 11])
    train = dict(patch_size=(16, 16, 16), steps_per_epoch=5, pos_frac=0.5, n_epoch=2,
                 batch_size=2, lr=1e-3, loss_fn="BinaryDiceLoss",
                 loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2}, seed=SEED,
                 on_device_sampling=device_sampler)
    jt = JaxUNet3D(JaxUNet(**NET3D), augment_fn=JT3.default_patch_augmentation(), **train)
    pt = UNet3D(UNet(key=rng.prng_key(SEED), **NET3D), augment_fn=T3.default_patch_augmentation(),
                device="cpu", **train)
    want, got = [], []
    _record_jax(jt, want)
    _record_port(pt, "_step", got)
    jt.train(JaxVolumeDataset3D(vols, masks, ids))
    pt.train(VolumeDataset3D(vols, masks, ids))
    assert len(want) == len(got) == 10
    assert len(set(np.round(got, 6))) > 5  # the steps see different patches
    np.testing.assert_allclose(got, want, rtol=1e-4)


MASK_KW = dict(n_draw=(1, 3), vertex=(2, 5), brush_width=(4, 8), length=(4, 10))
D_KW = dict(out_channels=(8, 16, 16), kernel_size=3)


def test_gan_steps_follow_jax(monkeypatch):
    images = np.random.default_rng(SEED).uniform(size=(12, 32, 32)).astype(np.float32)
    train = dict(n_epoch=1, batch_size=4, lr_g=1e-5, lr_d=1e-5, mask_kwargs=MASK_KW, seed=SEED)
    jt = JaxSNPatchGAN(JaxG(lat_channels=4), JaxD(**D_KW), **train)
    kg, kd = rng.split(rng.prng_key(SEED))
    pt = gan.SNPatchGAN(SAGatedGenerator(lat_channels=4, key=kg),
                        PatchDiscriminator(**D_KW, key=kd), device="cpu", **train)
    want, got, keys, masks = [], [], [], []
    _record_jax(jt, want, keys)
    _record_port(pt, "_train_step", got)
    draw = gan.random_ff_masks
    monkeypatch.setattr(gan, "random_ff_masks",
                        lambda *a, **kw: masks.append(draw(*a, **kw)) or masks[-1])
    jt.train(JaxLabeledSliceDataset(images, np.zeros(12)))
    pt.train(LabeledSliceDataset(images, np.zeros(12)))
    assert len(want) == len(got) == len(masks) == 3
    for k, m in zip(keys, masks):
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(JM.random_ff_masks(jax.random.split(k)[0], 4, (32, 32),
                                                     **MASK_KW)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


ELLIPSES = dict(n_ellipse=(1, 4), major_axis=(3, 10), minor_axis=(2, 8), intensity=(0.6, 1.0))


def test_fcdd_steps_follow_jax():
    gen = np.random.default_rng(SEED)
    images = gen.uniform(0.0, 0.5, size=(20, 32, 32)).astype(np.float32)
    labels = (np.arange(20) % 5 == 0).astype(np.float32)
    train = dict(anomaly_proba=0.5, drawing_params=ELLIPSES, n_epoch=2, batch_size=4, lr=1e-5,
                 seed=SEED)
    jt = JaxFCDD(JaxFCDDNet(), **train)
    pt = FCDD(FCDD_CNN_VGG(key=rng.prng_key(SEED)), device="cpu", **train)
    want, got = [], []
    _record_jax(jt, want)
    _record_port(pt, "_train_step", got)
    jt.train(JaxLabeledSliceDataset(images, labels))
    pt.train(LabeledSliceDataset(images, labels))
    assert len(want) == len(got) == 10
    np.testing.assert_allclose(got, want, rtol=1e-4)
