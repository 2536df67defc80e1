"""The port's sliding window (``ich_tpu_torch.ops.sliding_window``) against
the JAX package's on the same numpy-seeded volumes: the Gaussian map, the
patch grid, both routes, the dispatcher's route rule, and a 3D GroupNorm
U-Net carried from flax."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops import sliding_window as jsw
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import sliding_window as sw

torch.set_num_threads(2)

P16 = (16, 16, 16)


def _port(vol, apply_fn, **kw):
    return sw.sliding_window_inference(apply_fn, torch.from_numpy(vol), **kw).numpy()


def _jax(vol, apply_fn, variables=None, **kw):
    return np.asarray(jsw.sliding_window_inference(apply_fn, variables or {}, jnp.asarray(vol),
                                                   **kw))


@pytest.mark.parametrize("patch", [P16, (8, 12, 20), (64, 64, 64)])
def test_gaussian_map_matches_jax(patch):
    """sigma = patch/8, peak 1, floor 1e-2: within 1e-7."""
    want = jsw._gaussian_importance_np(patch)
    np.testing.assert_allclose(sw._gaussian_importance_np(patch), want, rtol=0, atol=1e-7)
    got = sw.gaussian_importance_map(patch).numpy()
    np.testing.assert_allclose(got, np.asarray(jsw.gaussian_importance_map(patch)), rtol=0,
                               atol=1e-7)
    assert got.max() == 1.0 and got.min() >= 1e-2


@pytest.mark.parametrize("shape,patch,overlap", [
    ((24, 24, 24), P16, 0.5), ((20, 20, 20), P16, 0.25), ((100, 512, 512), (64, 64, 64), 0.5),
    ((10, 12, 40), P16, 0.5), ((64, 512, 512), (128, 128, 128), 0.5)])
def test_patch_grid_and_coords_match_jax(shape, patch, overlap):
    for d, p in zip(shape, patch):
        for step in (1, p // 2, max(1, int(p * 0.75))):
            np.testing.assert_array_equal(sw.patch_grid(d, p, step), jsw.patch_grid(d, p, step))
    got = sw.make_patch_coords(shape, patch, overlap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jsw.make_patch_coords(shape, patch, overlap))


@pytest.mark.parametrize("shape,overlap", [
    ((24, 24, 24), 0.5),  # coset route (stride 8 divides 16)
    ((20, 20, 20), 0.25),  # general route (stride 12 does not)
    ((10, 12, 40), 0.5),  # smaller than a patch on two axes: padded
])
def test_identity_blend_matches_jax(shape, overlap):
    """An identity network blends back to the volume, within 1e-5 of JAX
    and of the input."""
    vol = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    kw = dict(patch_size=P16, overlap=overlap, batch_size=3)
    got = _port(vol, lambda x: x, **kw)
    assert got.shape == shape + (1,) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(vol, lambda v, x: x, **kw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 0], vol, rtol=0, atol=1e-5)


def test_compute_dtype_matches_jax():
    """compute_dtype=bf16 casts the volume before extraction; the blend
    stays float32. An identity network returns the bf16-rounded volume, as
    in JAX, within 1e-6."""
    vol = np.random.default_rng(4).uniform(size=(24, 24, 24)).astype(np.float32)
    got = _port(vol, lambda x: x, patch_size=P16, compute_dtype=torch.bfloat16)
    want = _jax(vol, lambda v, x: x, patch_size=P16, compute_dtype=jnp.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[..., 0] - vol).max() > 1e-4  # the input really was rounded


def _centred(x, axes):
    """A context-dependent 'network': each voxel minus its patch's mean, so
    a voxel's blend depends on which patches cover it."""
    return x - x.mean(axis=axes, keepdims=True)


def test_irregular_shape_routes_differ_and_each_matches_jax():
    """20x24x24, patch 16 at 0.5: the coset route pads D to 24 with starts
    0/8, the general route clamps to 0/4. The port's dispatcher must take
    JAX's route, and its general path must equal ``_sliding_window_jit``."""
    vol = np.random.default_rng(1).uniform(size=(20, 24, 24)).astype(np.float32)
    port_fn = lambda x: _centred(x, (2, 3, 4))  # noqa: E731
    jax_fn = lambda v, x: _centred(x, (1, 2, 3))  # noqa: E731
    assert sw._route(P16, 0.5, None) == (True, (8, 8, 8), 128)
    got = _port(vol, port_fn, patch_size=P16, overlap=0.5)
    np.testing.assert_allclose(got, _jax(vol, jax_fn, patch_size=P16, overlap=0.5),
                               rtol=0, atol=1e-5)

    coords = jsw.make_patch_coords(vol.shape, P16, 0.5)
    assert sorted(set(coords[:, 0].tolist())) == [0, 4]
    want = np.asarray(jsw._sliding_window_jit(
        {}, jnp.asarray(vol)[..., None], jnp.asarray(coords),
        jnp.ones(len(coords), jnp.float32), jax_fn, P16, 1, len(coords), packing="off"))
    general = sw._sliding_window_general(port_fn, torch.from_numpy(vol)[None], P16, 0.5, 4)
    general = general.permute(1, 2, 3, 0).numpy()
    np.testing.assert_allclose(general, want, rtol=0, atol=1e-5)
    assert np.abs(general - got).max() > 1e-2  # the two routes really differ


@pytest.mark.parametrize("patch,overlap,batch_size", [
    (P16, 0.5, None), (P16, 0.25, None), ((64, 64, 64), 0.5, None), ((64, 64, 64), 0.5, 32),
    ((128, 128, 128), 0.5, None), ((100, 100, 104), 0.5, None), ((8, 12, 20), 0.5, 2)])
def test_route_rule_matches_jax(monkeypatch, patch, overlap, batch_size):
    """The JAX dispatcher's choice, read by replacing its two jitted paths
    with recorders: coset iff prod(patch) <= 2**20 and the stride divides
    every side (128^3 = 2**21 goes to the general path), batch_size None ->
    128 on the coset path, 4 on the general one."""
    seen = {}

    def coset(variables, volume, apply_fn, patch_size, stride, batch_size, packing):
        seen.update(route=True, stride=stride, batch=batch_size)
        return jnp.zeros(volume.shape[:3] + (1,))

    def general(variables, volume, coords, keep, apply_fn, patch_size, batch_size, n, packing):
        seen.update(route=False, batch=batch_size)
        return jnp.zeros(volume.shape[:3] + (1,))

    monkeypatch.setattr(jsw, "_sliding_window_coset_jit", coset)
    monkeypatch.setattr(jsw, "_sliding_window_jit", general)
    jsw.sliding_window_inference(None, {}, jnp.zeros((8, 8, 8)), patch_size=patch,
                                 overlap=overlap, batch_size=batch_size)
    use_coset, strides, bs = sw._route(patch, overlap, batch_size)
    assert (use_coset, bs) == (seen["route"], seen["batch"])
    if use_coset:
        assert strides == seen["stride"]


@pytest.mark.parametrize("shape,overlap", [((24, 24, 24), 0.5), ((20, 20, 20), 0.25)])
def test_groupnorm_net_blend_matches_jax(shape, overlap):
    """A d2 f4 GroupNorm 3D U-Net carried from flax, on both routes, float32:
    probabilities within 1e-5."""
    kw = dict(depth=2, ndim=3, top_filter=4, norm="group", p_dropout=0.0)
    jnet = JaxUNet(**kw)
    v = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1,) + P16 + (1,))))
    net = UNet(**kw)
    net.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in unet_state_dict_from_jax(v).items()})
    net.eval()
    vol = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    want = _jax(vol, jnet.apply, v, patch_size=P16, overlap=overlap, batch_size=2)
    with torch.no_grad():
        got = _port(vol, net, patch_size=P16, overlap=overlap, batch_size=2)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
