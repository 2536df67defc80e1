"""The port's U-Net against the JAX package's, with weights initialised in
flax and carried over by ``unet_state_dict_from_jax``; inputs from numpy."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ich_tpu.interop.torch_port import port_unet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.train import checkpoint

torch.set_num_threads(2)


def _flax_variables(net, x, seed=0):
    """flax init, with BatchNorm running statistics made non-trivial."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    v = dict(v)
    if "batch_stats" in v:
        def stat(path, a):
            if "mean" in jax.tree_util.keystr(path):
                return rng.normal(0, 0.1, a.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

        v["batch_stats"] = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
    return v


def _port(variables, **kw):
    net = UNet(**kw)
    sd = unet_state_dict_from_jax(variables)
    net.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return net.eval()


CASES = {
    "2d_bn_convT": dict(depth=3, ndim=2, top_filter=8, midchannels_factor=2, norm="batch"),
    "2d_bn_bilinear": dict(depth=3, ndim=2, top_filter=8, midchannels_factor=2, norm="batch",
                           bilinear=True),
    "3d_gn_convT": dict(depth=3, ndim=3, top_filter=16, midchannels_factor=2, norm="group"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    kw = CASES[case]
    ndim = kw["ndim"]
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(2,) + (16,) * ndim + (1,)).astype(np.float32)  # channels-last
    jnet = JaxUNet(p_dropout=0.0, **kw)
    v = _flax_variables(jnet, x)
    want = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    net = _port(v, p_dropout=0.0, **kw)
    to_first = (0, ndim + 1) + tuple(range(1, ndim + 1))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(*to_first)).numpy()
    got = np.moveaxis(got, 1, -1)
    assert got.shape == want.shape
    assert want.std() > 1e-3  # the comparison is not of constants
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_state_dict_round_trips_through_port_unet():
    kw = CASES["2d_bn_convT"]
    x = np.zeros((1, 16, 16, 1), np.float32)
    v = _flax_variables(JaxUNet(p_dropout=0.0, **kw), x)
    net = _port(v, p_dropout=0.0, **kw)
    back = port_unet({k: t.numpy() for k, t in net.state_dict().items()})
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip(tmp_path):
    net = UNet(depth=2, top_filter=4, p_dropout=0.0)
    fn = str(tmp_path / "sub" / "w.pt")
    checkpoint.save_params(fn, net.state_dict())
    loaded = checkpoint.load_params(fn)
    assert loaded.keys() == net.state_dict().keys()
    for k, t in net.state_dict().items():
        assert torch.equal(loaded[k], t)


def test_unet_rejects_bad_ndim_and_dropout_list():
    with pytest.raises(ValueError):
        UNet(ndim=1)
    with pytest.raises(ValueError):
        UNet(depth=3, p_dropout=[0.1, 0.2])
