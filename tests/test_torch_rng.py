"""``ich_tpu_torch.utils.rng`` against jax.random (JAX 0.9.0, threefry
partitionable): keys and bits ``torch.equal``; the float samplers within
``ULPS`` units in the last place (``uniform`` is exact; ``normal`` and
``truncated_normal`` pass through ``erf_inv``, whose ``log1p`` the port
computes as XLA's CPU backend does but for its ``log``, which is one ulp
off in about 1 of 10^4 inputs); the helpers of ``ich_tpu.utils.rng``; and
the known answers ``chip_smoke.py`` holds the card to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.utils import rng as jax_rng
from ich_tpu_torch.utils import rng

ULPS = 4
SHAPES = [(), (1,), (7,), (3, 5), (70001,)]  # 0-d, odd, and past the host path's 2^16 words
SEEDS = [0, 42, 2**31 + 5]


def _key(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _ulps(a, b) -> int:
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max()) if ia.size else 0


@pytest.mark.parametrize("key,count,want", [
    # Random123's known answers for threefry2x32 with 20 rounds
    ((0x0, 0x0), (0x0, 0x0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_vectors(key, count, want):
    got = rng.threefry2x32(torch.tensor(key), torch.tensor([count[0]]), torch.tensor([count[1]]))
    assert [int(g[0]) for g in got] == list(want)
    from jax._src import prng
    j = prng.threefry_2x32(jnp.asarray(key, jnp.uint32), jnp.asarray(count, jnp.uint32))
    assert [int(v) for v in np.asarray(j)] == list(want)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    k, kp = jax.random.PRNGKey(seed), rng.prng_key(seed)
    assert torch.equal(_key(k), kp)
    for data in (0, 1, 12345, 2**32 - 1):
        assert torch.equal(_key(jax.random.fold_in(k, data)), rng.fold_in(kp, data))
    for num in (2, 3, 7, (2, 3)):
        assert torch.equal(_key(jax.random.split(k, num)), rng.split(kp, num))
    ks = jax.random.split(k, 5)
    assert torch.equal(_key(jax.vmap(lambda q: jax.random.split(q, 4))(ks)),
                       rng.split(_key(ks), 4))
    assert torch.equal(_key(jax.vmap(lambda q: jax.random.fold_in(q, 9))(ks)),
                       rng.fold_in(_key(ks), 9))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_equal_jax(seed, shape):
    k = jax.random.PRNGKey(seed)
    want = _key(jax.random.bits(k, shape, jnp.uint32))
    got = rng.random_bits(rng.prng_key(seed), shape)
    assert got.shape == want.shape and torch.equal(got, want)


def _jax_sampler(name, k, shape):
    if name == "uniform":
        return jax.random.uniform(k, shape, minval=-3.0, maxval=5.5)
    if name == "normal":
        return jax.random.normal(k, shape)
    if name == "truncated_normal":
        return jax.random.truncated_normal(k, -2.0, 2.0, shape)
    if name == "bernoulli":
        return jax.random.bernoulli(k, 0.3, shape)
    if name == "randint":
        return jax.random.randint(k, shape, 3, 1000)
    if name == "randint_wide":
        return jax.random.randint(k, shape, -5, 2**31 - 7)
    return jax.random.permutation(k, shape[0])


def _port_sampler(name, k, shape):
    if name == "uniform":
        return rng.uniform(k, shape, -3.0, 5.5)
    if name == "normal":
        return rng.normal(k, shape)
    if name == "truncated_normal":
        return rng.truncated_normal(k, -2.0, 2.0, shape)
    if name == "bernoulli":
        return rng.bernoulli(k, 0.3, shape)
    if name == "randint":
        return rng.randint(k, shape, 3, 1000)
    if name == "randint_wide":
        return rng.randint(k, shape, -5, 2**31 - 7)
    return rng.permutation(k, shape[0])


SAMPLERS = ["uniform", "normal", "truncated_normal", "bernoulli", "randint", "randint_wide",
            "permutation"]


@pytest.mark.parametrize("name,shape", [(n, s) for n in SAMPLERS for s in SHAPES
                                        if n != "permutation" or s in ((7,), (70001,))])
def test_samplers_equal_jax(name, shape):
    for seed in (0, 42):
        want = np.asarray(_jax_sampler(name, jax.random.fold_in(jax.random.PRNGKey(seed), 3),
                                       shape))
        got = _port_sampler(name, rng.fold_in(rng.prng_key(seed), 3), shape).numpy()
        assert got.shape == want.shape
        if want.dtype.kind == "f":
            assert got.dtype == np.float32 and _ulps(got, want) <= ULPS, (seed, _ulps(got, want))
            if name == "uniform":
                np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_truncated_normal_bounds_and_other_limits():
    k = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.truncated_normal(k, -0.5, 1.5, (4001,)))
    got = rng.truncated_normal(rng.prng_key(5), -0.5, 1.5, (4001,)).numpy()
    assert _ulps(got, want) <= ULPS and got.min() > -0.5 and got.max() < 1.5


def test_batched_keys_draw_as_vmap():
    ks = jax.random.split(jax.random.PRNGKey(11), 6)
    kp = _key(ks)
    np.testing.assert_array_equal(
        rng.uniform(kp, (4,)).numpy(), np.asarray(jax.vmap(lambda q: jax.random.uniform(q, (4,)))(ks)))
    np.testing.assert_array_equal(
        rng.randint(kp, (), 10, 31).numpy(),
        np.asarray(jax.vmap(lambda q: jax.random.randint(q, (), 10, 31))(ks)))
    np.testing.assert_array_equal(
        rng.permutation(kp, 30).numpy(), np.asarray(jax.vmap(lambda q: jax.random.permutation(q, 30))(ks)))


def test_erf_inv_within_ulps_of_xla():
    x = np.random.default_rng(0).uniform(-1, 1, 200_000).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = rng.erf_inv(torch.from_numpy(x)).numpy()
    assert _ulps(got, want) <= ULPS
    assert np.mean(got == want) > 0.999
    assert np.isinf(rng.erf_inv(torch.tensor([1.0, -1.0]))).all()


def test_helpers_equal_the_jax_package():
    k, kp = jax.random.PRNGKey(3), rng.prng_key(3)
    for name in ("augment", "dropout", "ψ"):
        assert torch.equal(_key(jax_rng.fold_in_name(k, name)), rng.fold_in_name(kp, name))
    js, ps = jax_rng.RngStream(k, "aug"), rng.RngStream(kp, "aug")
    for _ in range(3):
        assert torch.equal(_key(js.next()), ps.next())
    assert torch.equal(_key(js.at(7)), ps.at(7))
    assert torch.equal(_key(js.child("x").next()), ps.child("x").next())
    assert torch.equal(_key(jax_rng.RngStream(k).next()), rng.RngStream(kp).next())
    ids = np.array([0, 5, 99, 2**31])
    assert torch.equal(_key(jax_rng.per_sample_keys(k, ids)), rng.per_sample_keys(kp, ids))
    assert torch.equal(_key(jax_rng.seed_everything(9)), rng.prng_key(9))


def test_rbg_key_is_the_dropout_key():
    """Dropout's ``rbg`` key and its ``fold_in`` equal the JAX package's
    ``dropout_key`` and jax's ``fold_in`` on it; another key differs."""
    for seed in (1, 42):
        k = jax_rng.dropout_key(jax.random.PRNGKey(seed))
        want = [int(w) for w in np.asarray(jax.random.key_data(k))]
        got = rng.rbg_key(rng.prng_key(seed))
        assert list(got) == want
        for data in (0, 7, 2**32 - 1):
            assert list(rng.rbg_fold_in(got, data)) == [
                int(w) for w in np.asarray(jax.random.key_data(jax.random.fold_in(k, data)))]
    assert rng.rbg_key(rng.prng_key(1)) != rng.rbg_key(rng.fold_in(rng.prng_key(1), 1))


def test_the_chip_constants_are_jaxs():
    """``chip_smoke.py`` phase 15 holds the card to these: recomputed here
    with JAX, they must equal what the script carries."""
    import chip_smoke as cs
    from ich_tpu.models import UNet as JaxUNet
    from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax

    k, n = jax.random.PRNGKey(42), cs.RNG_WORDS
    bits = np.asarray(jax.random.bits(k, (n,), jnp.uint32)).astype(np.int64)
    u = np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n,), minval=-2.5, maxval=4.0))
    t = np.asarray(jax.random.truncated_normal(jax.random.fold_in(k, 2), -2.0, 2.0, (n,)))
    draws = {k: v for k, v in cs.RNG_KNOWN.items() if k != "paths"}  # test_torch_keyed_paths
    assert draws == {
        "fold_in_7": [int(x) for x in np.asarray(jax.random.fold_in(k, 7))],
        "split_3": [[int(x) for x in r] for r in np.asarray(jax.random.split(k, 3))],
        "bits_sum": int(bits.sum()), "bits_head": bits[:4].tolist(),
        "bits_tail": bits[-4:].tolist(),
        "uniform_head": [float(x) for x in u[:4]], "uniform_sum": float(u.astype(np.float64).sum()),
        "tn_head": [float(x) for x in t[:4]], "tn_sum": float(t.astype(np.float64).sum()),
    }
    assert n > rng.HOST_WORDS  # so that the card computes them
    kw, known = cs.NET_KNOWN["study_d4f16"]
    v = jax.tree_util.tree_map(np.asarray, JaxUNet(p_dropout=0.0, **kw).init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 1))))
    sd = unet_state_dict_from_jax(v)
    flat = np.concatenate([a.astype(np.float64).ravel() for a in sd.values() if a.dtype.kind == "f"])
    assert known == {"n": int(flat.size), "sum": float(flat.sum()), "sumsq": float((flat ** 2).sum()),
                     "head": [float(x) for x in sd["down_block.0.conv1.weight"].ravel()[:3]]}
