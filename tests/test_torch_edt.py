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


# -- the kernels' arithmetic, emulated in numpy ---------------------------------
# These mirror csrc/edt.cu step for step (the card runs the real thing in
# tests/test_torch_cuda.py and chip_smoke.py): Python floats are doubles, as
# the kernel's comparisons are (F - 2 x v is exact in both where F is, as
# the kernel's fma is), and np.float32 sums round as __fadd_rn does.

_SEGS = 8  # kSegs of csrc/edt.cu


def _build_segment_emulated(cost, lo, hi):
    """``build_segment``: the lower envelope of the parabolas of sites
    [lo, hi), intersections compared by cross-multiplying in double, one pop
    or push a step; returns the envelope as (F, g, v) triples."""
    env = [(float(cost[lo]) + float(lo * lo), cost[lo], lo)] + [None] * (hi - lo - 1)
    k, a, b, q, fa, fb = 0, lo, lo, lo + 1, 0.0, env[0][0]
    gq = cost[q] if q < hi else np.float32(0)
    fq = float(gq) + float(q * q)
    while q < hi:
        if k > 0 and (fq - fb) * (b - a) <= (fb - fa) * (q - b):
            k -= 1
            b, fb = a, fa
            if k > 0:
                fa, _, a = env[k - 1]
        else:
            k += 1
            env[k] = (fq, gq, q)
            a, fa, b, fb = b, fb, q, fq
            q += 1
            if q < hi:
                gq = cost[q]
                fq = float(gq) + float(q * q)
    return env[:k + 1]


def _minimiser_emulated(env, m2x):
    """Bisection for the first parabola whose next is worse at x (m2x = -2x),
    as ``evaluate_range`` searches."""
    lo, hi = 0, len(env) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if env[mid + 1][0] + m2x * env[mid + 1][2] <= env[mid][0] + m2x * env[mid][2]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _envelope_line_emulated(cost):
    """``build_segment`` on each of the line's ``_SEGS`` segments, then
    ``evaluate_range`` on each range of x: the segments from the first that
    holds the minimum at its start to the last that holds it at its end, each
    that can hold it somewhere in the range walked from its bisected start
    (keys F - 2 x v), and the least written."""
    n = len(cost)
    seg = -(-n // _SEGS)
    envs = [_build_segment_emulated(cost, lo, min(lo + seg, n)) for lo in range(0, n, seg)]
    out = np.empty(n, np.float32)
    for x0 in range(0, n, seg):
        x1 = min(x0 + seg, n)
        starts = [_minimiser_emulated(env, -2 * x0) for env in envs]
        v0 = [env[k][0] - 2 * x0 * env[k][2] for env, k in zip(envs, starts)]
        ends = [_minimiser_emulated(env, -2 * (x1 - 1)) for env in envs]
        v1 = [env[k][0] - 2 * (x1 - 1) * env[k][2] for env, k in zip(envs, ends)]
        first = v0.index(min(v0))
        last = max(first, max(i for i, v in enumerate(v1) if v == min(v1)))
        walked = [i for i in range(first, last + 1) if i in (first, last)
                  or (v1[i] <= v1[first] and v0[i] <= v0[last])]
        for i in walked:
            env, k, x = envs[i], starts[i], x0
            while x < x1:
                if k + 1 < len(env) and (env[k + 1][0] - 2 * x * env[k + 1][2]
                                         <= env[k][0] - 2 * x * env[k][2]):
                    k += 1
                else:
                    value = np.float32(env[k][1]) + np.float32((x - env[k][2]) ** 2)
                    out[x] = value if i == first else min(out[x], value)
                    x += 1
    return out


def _envelope_pass_emulated(g):
    return np.stack([_envelope_line_emulated(row) for row in g]) if len(g) else g.copy()


def _mask_rows_emulated(mask):
    """``mask_rows_kernel``: per row, a 32-bit ballot of the sites per chunk,
    the last site before each chunk, then the sweep back."""
    rows, n = mask.shape
    out = np.empty((rows, n), np.float32)
    none = -(1 << 20)
    for r in range(rows):
        chunks = (n + 31) // 32
        site = np.zeros(chunks * 32, bool)
        site[:n] = ~(mask[r] > 0)
        bal = [sum(1 << i for i in range(32) if site[c * 32 + i]) for c in range(chunks)]
        left_carry, carry = [], none
        for c in range(chunks):
            left_carry.append(carry)
            if bal[c]:
                carry = c * 32 + bal[c].bit_length() - 1
        carry = -none
        for c in reversed(range(chunks)):
            for lane in range(32):
                x = c * 32 + lane
                below = bal[c] & ((2 << lane) - 1)
                above = bal[c] & ~((1 << lane) - 1)
                left = c * 32 + below.bit_length() - 1 if below else left_carry[c]
                right = c * 32 + (above & -above).bit_length() - 1 if above else carry
                d = min(x - left, right - x)
                if x < n:
                    out[r, x] = d * d if d < 4096 else np.float32(edt.INF)
            if bal[c]:
                carry = c * 32 + (bal[c] & -bal[c]).bit_length() - 1
    return out


def _envelope_case(name):
    rng = np.random.default_rng(5)
    inf = np.float32(edt.INF)
    if name == "no_site":
        return np.full((3, 50), inf, np.float32)
    if name == "all_sites":
        return np.zeros((2, 40), np.float32)
    if name == "one_site_each_end":
        g = np.full((2, 37), inf, np.float32)
        g[0, 0] = g[1, -1] = 0.0
        return g
    if name == "tie":
        g = np.full((1, 9), inf, np.float32)
        g[0, 2] = g[0, 6] = 0.0  # x = 4 lies 2 from both
        return g
    if name == "far_sites":  # ranges whose nearest site changes sides
        g = np.full((2, 256), inf, np.float32)
        g[0, [3, 250]] = 0.0
        g[1, [0, 100, 101, 255]] = [7.0, 0.0, 2.0, 1.0]
        return g
    if name == "n1":
        return np.array([[0.0], [inf], [3.0]], np.float32)
    if name == "n4096":
        return _sites(rng, (3, 4096), p=0.002)
    if name == "second_pass":  # squared distances of a first pass, transposed
        first = edt.edt_pass_1d_plain(torch.from_numpy(_sites(rng, (24, 40), p=0.05)))
        return np.ascontiguousarray(first.numpy().T)
    if name == "sites_13x128":
        return _sites(np.random.default_rng(0), (13, 128))
    return np.random.default_rng(0).uniform(0, 500, size=(13, 128)).astype(np.float32)


@pytest.mark.parametrize("name", ["no_site", "all_sites", "one_site_each_end", "tie", "far_sites",
                                  "n1", "n4096", "second_pass", "sites_13x128", "costs_13x128"])
def test_envelope_arithmetic_equals_plain_pass(name):
    g = _envelope_case(name)
    want = edt.edt_pass_1d_plain(torch.from_numpy(g)).numpy()
    assert np.array_equal(_envelope_pass_emulated(g), want)


@pytest.mark.parametrize("shape", [(32, 32), (3, 24, 40), (2, 2, 16, 12), (2, 37, 70)])
def test_mask_kernel_arithmetic_equals_plain_transform(shape):
    """The W pass from the mask, then the envelope down the columns and the
    square root, against the plain composition; the mask has negative and
    NaN pixels, which are sites (not mask > 0) in both."""
    rng = np.random.default_rng(6)
    mask = (rng.uniform(size=shape) > 0.15).astype(np.float32)
    mask[..., 0, :] = 1.0  # a row without a site
    flat = mask.reshape((-1,) + shape[-2:])
    flat[0, 1, 3], flat[0, 2, 5] = -1.0, np.nan
    b, h, w = flat.shape
    d2 = _mask_rows_emulated(flat.reshape(b * h, w)).reshape(b, h, w)
    cols = np.ascontiguousarray(d2.transpose(0, 2, 1)).reshape(b * w, h)
    d2 = _envelope_pass_emulated(cols).reshape(b, w, h).transpose(0, 2, 1)
    got = np.sqrt(np.minimum(d2, np.float32(edt.INF))).reshape(shape)
    want = edt.distance_transform_edt_plain(torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(32, 32), (3, 24, 40), (2, 2, 16, 12)])
def test_plain_transform_matches_pallas_interpret_and_scipy(shape):
    from ich_tpu.ops.pallas_edt import distance_transform_edt_pallas

    rng = np.random.default_rng(7)
    mask = (rng.uniform(size=shape) > 0.15).astype(np.float32)
    mask[..., 0, 0] = 0
    got = edt.distance_transform_edt_plain(torch.from_numpy(mask)).numpy()
    want = np.asarray(distance_transform_edt_pallas(jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    flat = mask.reshape((-1,) + shape[-2:])
    ref = np.stack([ndi.distance_transform_edt(m) for m in flat]).reshape(shape)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cpu_transform_is_plain_and_launches_nothing():
    rng = np.random.default_rng(8)
    mask = torch.from_numpy((rng.uniform(size=(2, 3, 20, 17)) > 0.3).astype(np.float32))
    before = (edt.launches, edt.mask_launches)
    got = edt.distance_transform_edt_kernel(mask)
    assert torch.equal(got, edt.distance_transform_edt_plain(mask))
    assert (edt.launches, edt.mask_launches) == before == (0, 0)
