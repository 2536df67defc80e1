"""Every network family's fresh port net equals flax's ``init`` of its JAX
counterpart from the same key, through ``from_jax``: the keys and the
zeros and ones exactly, the drawn kernels (and a spectral norm's ``u``)
within ``ULPS`` units in the last place. The difference comes only from
rounding inside ``erf_inv`` (XLA's ``log`` on its CPU backend, which
``rng`` approximates) and is 0 for all but a few in 10^4 weights; a
spectral-norm layer's kernel, divided by its estimated norm at init as
flax leaves it, is held at ``SN_RTOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.models import AENet as JaxAENet
from ich_tpu.models import FCDD_CNN_VGG as JaxFCDD
from ich_tpu.models import PartialUNet as JaxPartialUNet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.models import UNetEncoder as JaxUNetEncoder
from ich_tpu.models import inpainting as JI
from ich_tpu.models import resnet as JR
from ich_tpu_torch.interop import from_jax as FJ
from ich_tpu_torch.models import inpainting as PI
from ich_tpu_torch.models import resnet as PR
from ich_tpu_torch.models.ae import AENet
from ich_tpu_torch.models.fcdd import FCDD_CNN_VGG
from ich_tpu_torch.models.init import flax_fold, init_like_flax, lecun_normal
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder
from ich_tpu_torch.utils import rng

ULPS = 4  # the bound held on every drawn float variable
# a spectral-norm layer's kernel is stored divided by its estimated norm,
# whose dot products the two packages sum in different orders
SN_RTOL = 2e-6


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 units in the last place."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _img(c=1, hw=32):
    return np.zeros((1, hw, hw, c), np.float32)


def _vol(c=1):
    return np.zeros((1, 16, 16, 16, c), np.float32)


UNET = dict(depth=3, top_filter=4, p_dropout=0.1)
GAN_IN = (np.zeros((1, 32, 32, 1), np.float32), np.zeros((1, 32, 32, 1), np.float32))

# family -> (JAX module, port constructor taking key, converter, JAX init inputs)
FAMILIES = {
    "unet2d_batchnorm": (JaxUNet(**UNET), lambda k: UNet(**UNET, key=k),
                         FJ.unet_state_dict_from_jax, (_img(),)),
    "unet2d_groupnorm_bilinear": (
        JaxUNet(**UNET, norm="group", bilinear=True, out_channels=2),
        lambda k: UNet(**UNET, norm="group", bilinear=True, out_channels=2, key=k),
        FJ.unet_state_dict_from_jax, (_img(),)),
    "unet3d_groupnorm": (JaxUNet(**UNET, ndim=3, norm="group"),
                         lambda k: UNet(**UNET, ndim=3, norm="group", key=k),
                         FJ.unet_state_dict_from_jax, (_vol(),)),
    "attention_unet_gated": (JaxUNet(**UNET, gated=True),
                             lambda k: UNet(**UNET, gated=True, in_channels=2, key=k),
                             FJ.unet_state_dict_from_jax, (_img(2),)),
    "unet_encoder_mlp": (JaxUNetEncoder(depth=3, top_filter=4, mlp_head=(16, 8)),
                         lambda k: UNetEncoder(depth=3, top_filter=4, mlp_head=(16, 8), key=k),
                         FJ.unet_encoder_state_dict_from_jax, (_img(),)),
    "partial_unet_head": (
        JaxPartialUNet(depth=4, n_decoder=2, top_filter=4, head_channel=(8, 4)),
        lambda k: PartialUNet(depth=4, n_decoder=2, top_filter=4, head_channel=(8, 4), key=k),
        FJ.partial_unet_state_dict_from_jax, (_img(),)),
    "resnet18": (JR.resnet18(num_classes=2), lambda k: PR.resnet18(num_classes=2, key=k),
                 FJ.resnet_state_dict_from_jax, (_img(hw=64),)),
    "resnet50": (JR.resnet50(num_classes=3), lambda k: PR.resnet50(num_classes=3, key=k),
                 FJ.resnet_state_dict_from_jax, (_img(hw=64),)),
    "gated_generator_contextual": (
        JI.GatedGenerator(lat_channels=4), lambda k: PI.GatedGenerator(lat_channels=4, key=k),
        FJ.gated_generator_state_dict_from_jax, GAN_IN),
    "sa_gated_generator": (
        JI.SAGatedGenerator(lat_channels=4),
        lambda k: PI.SAGatedGenerator(lat_channels=4, key=k),
        FJ.sa_gated_generator_state_dict_from_jax, GAN_IN),
    "patch_discriminator_sn": (
        JI.PatchDiscriminator(out_channels=(8, 16, 16, 16), kernel_size=5),
        lambda k: PI.PatchDiscriminator(out_channels=(8, 16, 16, 16), kernel_size=5, key=k),
        FJ.patch_discriminator_state_dict_from_jax, GAN_IN),
    "aenet_convt": (JaxAENet(latent_channels=4, bottleneck_channels=6, n_conv=2),
                    lambda k: AENet(latent_channels=4, bottleneck_channels=6, n_conv=2, key=k),
                    FJ.ae_state_dict_from_jax, (_img(),)),
    "aenet_bilinear": (
        JaxAENet(latent_channels=4, bottleneck_channels=6, n_conv=2, bilinear=True),
        lambda k: AENet(latent_channels=4, bottleneck_channels=6, n_conv=2, bilinear=True,
                        key=k),
        FJ.ae_state_dict_from_jax, (_img(),)),
    "fcdd_cnn_vgg": (JaxFCDD(), lambda k: FCDD_CNN_VGG(key=k), FJ.fcdd_state_dict_from_jax,
                     (_img(),)),
}


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fresh_net_equals_flax_init(family, seed):
    jnet, build, convert, inputs = FAMILIES[family]
    key = jax.random.PRNGKey(seed)
    rngs = {"params": key, "dropout": key}
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jnet.init(rngs, *(jnp.asarray(x) for x in inputs))))
    want = convert(variables)
    got = build(rng.prng_key(seed)).state_dict()
    assert set(want) <= set(got)
    for name, a in want.items():
        b = got[name].numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind != "f":
            assert np.array_equal(a, b), name
        elif name.replace(".conv.weight", ".u") in want and name.endswith(".conv.weight"):
            np.testing.assert_allclose(b, a, rtol=SN_RTOL, atol=0, err_msg=name)
        else:
            assert _ulps(a, b) <= ULPS, (name, _ulps(a, b))
    # every parameter the port has is one flax draws
    assert {n for n, _ in build(rng.prng_key(seed)).named_parameters()} <= set(want)


def test_seed_picks_the_net_and_none_is_seed_zero():
    a = UNet(**UNET, key=rng.prng_key(1)).state_dict()
    b = UNet(**UNET, key=rng.prng_key(2)).state_dict()
    assert not torch.equal(a["final_conv.weight"], b["final_conv.weight"])
    c, d = UNet(**UNET).state_dict(), UNet(**UNET, key=rng.prng_key(0)).state_dict()
    assert all(torch.equal(c[k], d[k]) for k in c)


def test_flax_fold_and_lecun_normal_match_flax():
    """The per-variable key is flax's LazyRng fold, and lecun_normal is
    flax's initializer of a kernel in its layout."""
    import flax.linen as nn

    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(5, name="b")(nn.Conv(3, (3, 3), name="a")(x))

    key = jax.random.PRNGKey(7)
    v = Two().init({"params": key}, jnp.zeros((1, 4, 4, 2)))["params"]
    for name, shape in (("a", (3, 3, 2, 3)), ("b", (3, 5))):
        k = rng.fold_in(rng.prng_key(7), flax_fold((name,), 1))
        got = lecun_normal(k, shape).numpy()
        assert _ulps(np.asarray(v[name]["kernel"]), got) <= ULPS


def test_init_raises_on_an_undrawn_parameter():
    net = UNet(**UNET)
    net.extra = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="undrawn"):
        init_like_flax(net, rng.prng_key(0))
