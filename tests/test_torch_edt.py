"""The port's EDT (ich_tpu_torch.ops.edt / distance / losses) against the
JAX package on the same numpy-seeded inputs, on the CPU (the plain path)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

from ich_tpu.ops.distance import distance_to_set as jax_distance_to_set
from ich_tpu.ops.distance import distance_transform_edt as jax_edt
from ich_tpu.ops.losses import discounted_l1_loss as jax_discounted_l1
from ich_tpu.ops.pallas_edt import edt_pass_1d as jax_edt_pass_1d
from ich_tpu_torch.kernels import _build
from ich_tpu_torch.ops import edt
from ich_tpu_torch.ops.distance import distance_to_set, distance_transform_edt
from ich_tpu_torch.ops.losses import discounted_l1_loss

torch.set_num_threads(2)


def _sites(rng, shape, p=0.1):
    return np.where(rng.uniform(size=shape) < p, 0.0, edt.INF).astype(np.float32)


@pytest.mark.parametrize("kind", ["sites", "costs"])
def test_pass_plain_matches_pallas_interpret(kind):
    rng = np.random.default_rng(0)
    g = (_sites(rng, (13, 128)) if kind == "sites"
         else rng.uniform(0, 500, size=(13, 128)).astype(np.float32))
    want = np.asarray(jax_edt_pass_1d(jnp.asarray(g), interpret=True))
    got = edt.edt_pass_1d_plain(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cpu_pass_is_plain_and_launches_nothing():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(_sites(rng, (40, 33)))
    before = edt.launches
    got = edt.edt_pass_1d(g)
    distance_transform_edt(torch.from_numpy((rng.uniform(size=(2, 16, 16)) > 0.5)
                                            .astype(np.float32)))
    assert torch.equal(got, edt.edt_pass_1d_plain(g))
    assert edt.launches == before == 0


@pytest.mark.parametrize("shape", [(32, 32), (3, 24, 40), (2, 2, 16, 12)])
def test_distance_transform_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(2)
    mask = (rng.uniform(size=shape) > 0.15).astype(np.float32)
    mask[..., 0, 0] = 0  # at least one zero pixel per image
    got = distance_transform_edt(torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_edt(jnp.asarray(mask))), atol=1e-4)
    flat = mask.reshape((-1,) + shape[-2:])
    want = np.stack([ndi.distance_transform_edt(m) for m in flat]).reshape(shape)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_all_ones_saturates():
    d = distance_transform_edt(torch.ones(2, 9, 7))
    assert torch.all(d == 1e5)


def test_distance_to_set_matches_jax():
    rng = np.random.default_rng(3)
    site = (rng.uniform(size=(2, 20, 20)) > 0.9).astype(np.float32)
    got = distance_to_set(torch.from_numpy(site)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_distance_to_set(jnp.asarray(site))),
                               atol=1e-4)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_discounted_l1_matches_jax(reduction):
    rng = np.random.default_rng(4)
    rec = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    im = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[0, 4:20, 6:28] = 1.0
    mask[1, 10:30, 2:12] = 1.0
    mask[1, 0:3, 25:32] = 1.0  # touches the border: dilation pads with -inf
    want = np.asarray(jax_discounted_l1(jnp.asarray(rec), jnp.asarray(im), jnp.asarray(mask),
                                        gamma=0.99, reduction=reduction))
    got = discounted_l1_loss(torch.from_numpy(rec), torch.from_numpy(im),
                             torch.from_numpy(mask), gamma=0.99, reduction=reduction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


def test_edt_pass_1d_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        edt.edt_pass_1d(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        edt.edt_pass_1d(torch.zeros(2, 4, 8))
    # neither CPU nor CUDA: no silent route to the plain version
    with pytest.raises(ValueError):
        edt.edt_pass_1d(torch.zeros(4, 8, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
