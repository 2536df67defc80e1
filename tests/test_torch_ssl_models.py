"""The port's SSL networks against the JAX package's, with weights
initialised in flax and carried over by ``interop.from_jax``: the U-Net's
bottleneck output, ``UNetEncoder`` and ``PartialUNet`` in eval and train
mode, ``norm="none"``, and the bottleneck features of the representation
evaluation, all within 1e-5; the copied config helpers and the network
registry."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.interop.torch_port import port_partial_unet, port_unet_encoder
from ich_tpu.models import PartialUNet as JaxPartialUNet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.models import UNetEncoder as JaxUNetEncoder
from ich_tpu.train.ssl import ContextRestoration as JaxContextRestoration
from ich_tpu.train.ssl import Contrastive as JaxContrastive
from ich_tpu.utils import config as jax_config
from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.interop.from_jax import (
    partial_unet_state_dict_from_jax,
    unet_encoder_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.ssl import ContextRestoration, Contrastive
from ich_tpu_torch.utils import config

torch.set_num_threads(2)

SMALL = dict(depth=3, top_filter=4, midchannels_factor=2, p_dropout=0.0)


def _variables(net, x, seed=0):
    """flax init with the BatchNorm running statistics made non-trivial."""
    rng = np.random.default_rng(seed)
    v = dict(jax.tree_util.tree_map(np.array, net.init(jax.random.PRNGKey(seed), jnp.asarray(x))))
    if "batch_stats" in v:
        def stat(path, a):
            if "mean" in jax.tree_util.keystr(path):
                return rng.normal(0, 0.1, a.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

        v["batch_stats"] = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
    return v


def _load(net, sd):
    net.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return net


def _x(shape=(3, 32, 32, 1), seed=1):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


NETS = {
    "encoder": (JaxUNetEncoder, UNetEncoder, unet_encoder_state_dict_from_jax,
                dict(mlp_head=(16, 8))),
    "partial": (JaxPartialUNet, PartialUNet, partial_unet_state_dict_from_jax,
                dict(n_decoder=1, head_channel=(8, 4))),
    "unet": (JaxUNet, UNet, unet_state_dict_from_jax, dict(use_final_activation=False)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(NETS))
def test_ssl_nets_match_jax(name, train):
    """Outputs and bottleneck features within 1e-5 in eval mode. In train
    mode each BatchNorm normalises by the batch's variance, which flax takes
    in one pass (E[x^2] - E[x]^2, digits lost where the mean is large
    against the spread) and torch in two; through the decoder's norms that
    grows to about 1e-4 at this 3-sample batch, so train mode is held at
    2e-4, and the running statistics, updated as flax does, at rtol 1e-4."""
    jcls, pcls, convert, kw = NETS[name]
    x = _x()
    jnet = jcls(**SMALL, **kw)
    v = _variables(jnet, x)
    pnet = _load(pcls(**SMALL, **kw), convert(v)).train(train)
    if train:
        (out, bott), mut = jnet.apply(v, jnp.asarray(x), train=True, return_bottleneck=True,
                                      mutable=["batch_stats"])
    else:
        out, bott = jnet.apply(v, jnp.asarray(x), train=False, return_bottleneck=True)
    got, gbott = pnet(torch.from_numpy(x).permute(0, 3, 1, 2), return_bottleneck=True)
    got = got.detach()
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    gbott = gbott.detach()
    if gbott.dim() == 4:
        gbott = gbott.permute(0, 2, 3, 1)
    _close(got, out, atol=2e-4 if train else 1e-5)
    _close(gbott, bott, atol=2e-4 if train else 1e-5)
    if train:
        stats = convert({"params": v["params"], "batch_stats": mut["batch_stats"]})
        sd = pnet.state_dict()
        for k, a in stats.items():
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), a, rtol=1e-4, atol=1e-6, err_msg=k)


def test_converters_invert_the_reference_ports():
    """A port state_dict through ``ich_tpu.interop.torch_port`` and back is
    the same; the Dense kernel is transposed on the way."""
    torch.manual_seed(0)
    for pnet, port, convert in ((UNetEncoder(**SMALL, mlp_head=(16, 8)), port_unet_encoder,
                                 unet_encoder_state_dict_from_jax),
                                (PartialUNet(**SMALL, n_decoder=2, head_channel=(8, 4)),
                                 port_partial_unet, partial_unet_state_dict_from_jax)):
        sd = {k: v.numpy() for k, v in pnet.state_dict().items()}
        back = convert(jax.tree_util.tree_map(np.asarray, port(sd)))
        assert set(back) == set(sd)
        for k, a in sd.items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)
    assert back["final_conv.conv_layers.0.weight"].shape == (8, 4, 1, 1)


def test_norm_none_is_the_identity_and_matches_jax():
    """``norm="none"`` builds (it used to raise), holds no norm keys, and
    with carried weights agrees with the JAX ``UNet(norm="none")``."""
    x = _x((2, 16, 16, 1), seed=2)
    jnet = JaxUNet(depth=3, top_filter=4, norm="none", p_dropout=0.0)
    v = _variables(jnet, x)
    assert "batch_stats" not in v
    sd = unet_state_dict_from_jax(v)
    assert not any(".bn" in k for k in sd)
    pnet = _load(UNet(depth=3, top_filter=4, norm="none", p_dropout=0.0), sd).eval()
    want = jnet.apply(v, jnp.asarray(x), train=False)
    got = pnet(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1)
    _close(got, want)


@pytest.mark.parametrize("name", ["unet", "encoder"])
def test_bottleneck_features_match_jax(name):
    """``bottleneck_features`` on the device against JAX's
    ``_bottleneck_fn``: the 2x2 bottleneck of a 16x16 depth-4 net pools to
    a 2x2 grid and flattens channels last; the encoder's pooled vector."""
    x = _x((5, 16, 16, 1), seed=3)
    if name == "unet":
        jnet = JaxUNet(depth=4, top_filter=4, p_dropout=0.0, use_final_activation=False)
        v = _variables(jnet, x)
        pnet = _load(UNet(depth=4, top_filter=4, p_dropout=0.0, use_final_activation=False),
                     unet_state_dict_from_jax(v))
        jt, pt = JaxContextRestoration(jnet, batch_size=2), ContextRestoration(
            pnet, batch_size=2, device="cpu")
    else:
        jnet = JaxUNetEncoder(**SMALL, mlp_head=(16, 8))
        v = _variables(jnet, x)
        pnet = _load(UNetEncoder(**SMALL, mlp_head=(16, 8)), unet_encoder_state_dict_from_jax(v))
        jt, pt = JaxContrastive(jnet, batch_size=2), Contrastive(pnet, batch_size=2,
                                                                 device="cpu")
    want = np.asarray(jt._bottleneck_fn()(v, jnp.asarray(x[..., 0])))
    got = pt.bottleneck_features(LabeledSliceDataset(x[..., 0], np.zeros(5)))
    assert got.shape == want.shape
    _close(got, want)
    assert not pt.net.training


def test_config_helpers_match_jax(tmp_path):
    data = {"a": {"b": [1, {"c": 2}]}, "d": "x"}
    for mod in (config, jax_config):
        ad = mod.AttrDict.from_nested_dicts(data)
        assert ad.a.b[1].c == 2 and ad.to_dict() == data
        assert mod.rgetattr(ad, "a.b")[0] == 1 and mod.rgetattr(ad, "a.z", None) is None
        path = str(tmp_path / f"{mod.__name__}.json")
        mod.Config(data).save_config(path)
        assert mod.Config().load_config(path).settings.to_dict() == data
        copy = ad.copy()
        copy.a.b[1].c = 3
        assert ad.a.b[1].c == 2
        with pytest.raises(AttributeError):
            ad.nope  # noqa: B018
    with open(tmp_path / f"{config.__name__}.json") as f, \
            open(tmp_path / f"{jax_config.__name__}.json") as g:
        assert json.load(f) == json.load(g)


def test_network_registry_and_freeze_mask():
    net = config.NETWORKS.build("UNet_Encoder", depth=3, top_filter=4, MLP_head=[16, 8])
    assert isinstance(net, UNetEncoder) and len(net.mlp_head.fc_layers) == 2
    part = config.NETWORKS.build("Partial_UNet", depth=3, top_filter=4, n_decoder=1,
                                 head_channel=[8, 4])
    assert isinstance(part, PartialUNet) and len(part.up_block) == 1
    unet = config.NETWORKS.build("UNet", use_3D=True, depth=2, top_filter=4)
    assert isinstance(unet, UNet) and unet.ndim == 3
    gated = config.NETWORKS.build("GatedUNet", depth=2, top_filter=4)
    assert isinstance(gated, UNet) and gated.bottleneck_block.gated
    assert gated.down_block[0].conv1.weight.shape[1] == 2  # image and attention map
    names = [k for k, _ in part.named_parameters()]
    moved = [k for k in part.state_dict() if k.startswith("down_block.0.")]
    frozen = ckpt.freeze_mask(names, moved)
    assert frozen == {k for k in names if k.startswith("down_block.0.")}
    assert not any("running" in k for k in frozen)
