"""Explicit random keys (counterpart of :mod:`ich_tpu.utils.rng`), computed
as ``jax.random`` computes them.

jax.random's default generator is threefry2x32, a counter-based hash that
needs only 32-bit integer arithmetic, so the port computes the JAX
package's key tree exactly without JAX: one seed gives the same keys, bits
and draws on every torch build and device, and the same as the JAX
package's. The algorithms follow JAX 0.9.0 with
``jax_threefry_partitionable`` on (its default):

- :func:`threefry2x32`: 20 rounds with the rotation table and key
  injection of ``jax/_src/prng.py`` (``_threefry2x32_lowering``);
- :func:`prng_key` (``threefry_seed``), :func:`fold_in`, :func:`split`
  (the fold-like split) and :func:`random_bits` (``iota_2x32_shape``
  counters, ``bits1 ^ bits2``), all from ``jax/_src/prng.py``;
- the samplers :func:`uniform`, :func:`normal`, :func:`truncated_normal`,
  :func:`bernoulli`, :func:`randint` and :func:`permutation` of
  ``jax/_src/random.py``; ``erf_inv`` is XLA's float32 polynomial, to
  which ``lax.erf_inv`` lowers.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; leading
axes batch the keys, as ``jax.vmap`` over keys does, and every function
broadcasts over them. Keys live on the host. A draw runs on the host
(numpy uint32, then one copy to ``device``) when it is small, which keeps
a train step's per-sample draws from adding launches, and as int64 torch
ops masked to 32 bits on ``device`` when it is large (the initial weights
of a net built there).

Dropout draws from the ``rbg`` key that the JAX package derives from the
step's key (:func:`rbg_key`, :func:`rbg_fold_in`): ``jax.random.bits`` on
such a key is XLA's ``rng_bit_generator`` with its DEFAULT algorithm,
which XLA's CPU and GPU backends expand as Philox4x32-10
(:func:`philox_bits`, after XLA's ``lib/prng.cc``). A TPU draws
its own bits there; the port follows the CPU's.

jax.random is Apache-2.0; each algorithm copied from it names its source.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Shape = Union[int, Sequence[int]]

_MASK = 0xFFFFFFFF
# jax/_src/prng.py `_threefry2x32_lowering`: the rotations of the even and
# odd groups of four rounds, and the key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# draws of up to this many words run on the host
HOST_WORDS = 1 << 16


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _threefry(k0, k1, x0, x1, wrap):
    """The threefry2x32 rounds on numpy uint32 arrays (``wrap`` the
    identity) or int64 tensors (``wrap`` masks to 32 bits)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = wrap(x0 + k0), wrap(x1 + k1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = wrap((x1 << r) | (x1 >> (32 - r))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _mask(v: torch.Tensor) -> torch.Tensor:
    return v & _MASK


def threefry2x32(key: torch.Tensor, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter words ``(x0, x1)`` under ``key``
    (``(..., 2)``), broadcast together; two int64 tensors of uint32 values,
    on the counters' device."""
    key = torch.as_tensor(key)
    x0, x1 = torch.as_tensor(x0, dtype=torch.int64), torch.as_tensor(x1, dtype=torch.int64)
    k0, k1 = key[..., 0].to(x0.device), key[..., 1].to(x0.device)
    return _threefry(k0 & _MASK, k1 & _MASK, x0 & _MASK, x1 & _MASK, _mask)


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A host draw on ``device`` (None: the CPU): to a card, one copy from
    pinned memory, which does not wait for the card's queued work as a copy
    from pageable memory does."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _host_key(key: torch.Tensor) -> np.ndarray:
    return np.asarray(torch.as_tensor(key).cpu().numpy(), dtype=np.int64).astype(np.uint32)


def _counter_words(key: torch.Tensor, shape: Tuple[int, ...], device) -> Tuple:
    """threefry2x32 of every key of ``key`` (``(..., 2)``) over the flat
    index of ``shape`` split into its high and low words
    (``iota_2x32_shape``): two int64 tensors ``key.shape[:-1] + shape`` on
    ``device``."""
    batch = tuple(key.shape[:-1])
    out_shape = batch + shape
    n = math.prod(shape)
    words = math.prod(out_shape)
    device = torch.device("cpu") if device is None else torch.device(device)
    if words <= HOST_WORDS:
        k = _host_key(key).reshape(batch + (1,) * len(shape) + (2,))
        idx = np.arange(n, dtype=np.uint64).reshape(shape)
        full = (1,) if not out_shape else out_shape  # numpy scalars warn on overflow
        hi = np.broadcast_to((idx >> np.uint64(32)).astype(np.uint32), full).copy()
        lo = np.broadcast_to(idx.astype(np.uint32), full).copy()
        k0 = np.broadcast_to(k[..., 0], full).copy()
        k1 = np.broadcast_to(k[..., 1], full).copy()
        b0, b1 = _threefry(k0, k1, hi, lo, lambda v: v)
        return tuple(to_device(torch.from_numpy(b.astype(np.int64).reshape(out_shape)), device)
                     for b in (b0, b1))
    if device.type == "cpu" and not batch:
        # one key's large draw on the host: in cache-sized chunks of words,
        # about 3x faster than one pass over the whole
        parts = [threefry2x32(key, idx >> 32, idx & _MASK) for idx in
                 torch.arange(n, dtype=torch.int64).split(HOST_WORDS)]
        return tuple(torch.cat(p).reshape(shape) for p in zip(*parts))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    k = torch.as_tensor(key).to(device).reshape(batch + (1,) * len(shape) + (2,))
    return threefry2x32(k, idx >> 32, idx & _MASK)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (high, low) of the seed
    taken as a 32-bit value, as JAX does outside x64 mode
    (``threefry_seed``, ``jax/_src/prng.py``)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device="cpu")



def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry2x32 of ``(0, data)`` under ``key``
    (``threefry_fold_in``); ``data`` an int in [0, 2**32) or an int array
    broadcast against the keys' batch axes."""
    d = np.asarray(data, dtype=np.int64)
    k = _host_key(key)
    full = np.broadcast_shapes(k.shape[:-1], d.shape) or (1,)  # numpy scalars warn on overflow
    x1 = np.broadcast_to((d & _MASK).astype(np.uint32), full).copy()
    k0 = np.broadcast_to(k[..., 0], full).copy()
    k1 = np.broadcast_to(k[..., 1], full).copy()
    b0, b1 = _threefry(k0, k1, np.zeros(full, np.uint32), x1, lambda v: v)
    out = np.stack([b0, b1], axis=-1).astype(np.int64)
    return torch.from_numpy(out.reshape(np.broadcast_shapes(k.shape[:-1], d.shape) + (2,)))


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``, the fold-like split of the partitionable
    threefry (``_threefry_split_foldlike``): ``key.shape[:-1] + num + (2,)``."""
    key = torch.as_tensor(key)
    b0, b1 = _counter_words(key, _shape(num), None)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits (``_threefry_random_bits_partitionable``):
    int64 of uint32 values, ``key.shape[:-1] + shape``, on ``device``."""
    b0, b1 = _counter_words(torch.as_tensor(key), _shape(shape), device)
    return b0 ^ b1


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend contracts it:
    the product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from 32 random bits: the top 23 as the mantissa of a
    float in [1, 2), minus 1 (``_uniform``, ``jax/_src/random.py``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``max(minval, u (maxval - minval) +
    minval)``, the bounds float32 and broadcast against the result."""
    shape = _shape(shape)
    floats = _bits_to_unit(random_bits(key, shape, device))
    dev = floats.device
    lo, hi = _f32(minval, dev), _f32(maxval, dev)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``sum c_i x^(n-i)`` by Horner's rule with each step fused, as XLA's
    ``EvaluatePolynomial`` runs on its CPU backend."""
    p = torch.full_like(x, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(float(np.float32(c)), x.device))
    return p


# XLA's float32 log on its CPU backend (the Cephes polynomial of
# xla/service/cpu/polynomial_approximations.cc) and log1p
# (xla/service/elemental_ir_emitter.cc `EmitLog1p`: Cephes' rational
# approximation below sqrt(2) - 1, log(1 + x) above)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log(a: torch.Tensor) -> torch.Tensor:
    """float32 log of positive finite ``a``: the mantissa in [sqrt(1/2),
    sqrt 2) minus 1 through a degree-8 polynomial, plus the exponent times
    ln 2 in two parts."""
    m, e = torch.frexp(a)
    e = e.to(torch.float32)
    low = m < float(np.float32(0.707106781186547524))
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    p = [_f32(float(np.float32(c)), a.device) for c in _LOG_P]
    x2 = x * x
    x3 = x2 * x
    y, y1, y2 = _fma(p[0], x, p[1]), _fma(p[3], x, p[4]), _fma(p[6], x, p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(e, _f32(-2.12194440e-4, a.device), y)
    x = _fma(_f32(-0.5, a.device), x2, x) + y
    return _fma(e, _f32(0.693359375, a.device), x)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p of ``x`` in (-1, 0] as XLA's CPU backend computes it."""
    x2 = x * x
    small = x + _fma(_f32(-0.5, x.device), x2, (x * x2) * (_horner(x, _LOG1P_NUM)
                                                           / _horner(x, _LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, small, _log(x + 1.0))


# XLA's float32 erf_inv (xla/client/lib/math.cc `ErfInv32`, M. Giles'
# single-precision approximation): the coefficients for w < 5 and w >= 5
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` as XLA computes it: ``w = -log1p(-x^2)``, a
    degree-8 polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times
    ``x``; +-inf at +-1."""
    x = x.to(torch.float32)
    w = -_log1p(-x * x)
    lt = w < 5.0
    # sqrt through float64, rounded once to float32 as XLA's is: the card's
    # float32 sqrt is not always correctly rounded
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).to(torch.float32) - 3.0)
    p = torch.where(lt, _f32(_ERF_INV_LT5[0], x.device), _f32(_ERF_INV_GE5[0], x.device))
    for a, b in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(a, x.device), _f32(b, x.device)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) erf_inv(u)``, ``u``
    uniform on [nextafter(-1, 0), 1) (``_normal_real``)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _f32(_SQRT2, u.device) * erf_inv(u)


def truncated_normal(key: torch.Tensor, lower=-2.0, upper=2.0, shape: Shape = (),
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32 (``_truncated_normal``):
    ``sqrt(2) erf_inv(u)``, ``u`` uniform between ``erf(lower / sqrt 2)``
    and ``erf(upper / sqrt 2)``, clipped to the open interval."""
    lower32, upper32 = np.float32(lower), np.float32(upper)
    sq = _f32(_SQRT2, "cpu")
    a = torch.erf(_f32(lower32, "cpu") / sq)
    b = torch.erf(_f32(upper32, "cpu") / sq)
    u = uniform(key, shape, a, b, device)
    out = _f32(_SQRT2, u.device) * erf_inv(u)
    lo = float(np.nextafter(lower32, np.float32(np.inf)))
    hi = float(np.nextafter(upper32, np.float32(-np.inf)))
    return torch.clamp(out, lo, hi)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (``_bernoulli``): ``uniform < p`` in float32."""
    u = uniform(key, shape, device=device)
    return u < _f32(p, u.device)


def randint(key: torch.Tensor, shape: Shape, minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 (``_randint``): two words of bits
    per value from the two halves of ``split(key)``, reduced modulo the span
    in wrapping uint32 arithmetic. int64 values."""
    shape = _shape(shape)
    key = torch.as_tensor(key)
    # both halves' bits in one pass: the split keys batched
    higher, lower = random_bits(split(key), shape, device).unbind(key.dim() - 1)
    dev = higher.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = torch.where(hi <= lo, torch.ones_like(hi - lo), (hi - lo) & _MASK)
    multiplier = ((65536 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * multiplier & _MASK) + lower % span) & _MASK
    return lo + offset % span


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``_shuffle``): ``arange(n)``
    stably sorted by fresh random words, ``ceil(3 ln n / ln(2^32 - 1))``
    times. ``key.shape[:-1] + (n,)`` int64."""
    key = torch.as_tensor(key)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device="cpu").expand(tuple(key.shape[:-1]) + (n,))
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        order = torch.argsort(random_bits(sub, (n,)), dim=-1, stable=True)
        x = torch.gather(x, -1, order)
    return x


def fold_in_name(key: torch.Tensor, name: str) -> torch.Tensor:
    """Fold a string into a key: the first 4 bytes of its SHA-256, little
    endian (``ich_tpu/utils/rng.py`` ``fold_in_name``)."""
    digest = hashlib.sha256(name.encode("utf-8")).digest()
    return fold_in(key, int.from_bytes(digest[:4], "little"))


class RngStream:
    """A named, counted stream of keys: ``next()`` returns a fresh key each
    call, ``at(i)`` the i-th without advancing."""

    def __init__(self, key: torch.Tensor, name: str = ""):
        self._base = fold_in_name(key, name) if name else torch.as_tensor(key)
        self._count = 0
        self.name = name

    def next(self) -> torch.Tensor:
        k = fold_in(self._base, self._count)
        self._count += 1
        return k

    def at(self, i: int) -> torch.Tensor:
        return fold_in(self._base, i)

    def child(self, name: str) -> "RngStream":
        return RngStream(self._base, name)


def per_sample_keys(key: torch.Tensor, sample_ids) -> torch.Tensor:
    """One key per (global) sample id: ``fold_in(key, id)`` for each,
    ``(n, 2)``."""
    return fold_in(key, np.asarray(sample_ids, dtype=np.int64))


# XLA's Philox4x32-10 (its lib/prng.cc): the round multipliers
# and the key's increments between rounds
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _threefry_int(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """threefry2x32 of one counter under one key in Python ints: some ten
    microseconds, where a numpy call on one word costs some hundred."""
    return _threefry(k0, k1, x0, x1, lambda v: v & _MASK)


def rbg_key(key: torch.Tensor) -> Tuple[int, int, int, int]:
    """The ``rbg`` key that ``ich_tpu.utils.rng.dropout_key`` makes of a
    threefry key: ``jax.random.bits(key, (4,), uint32)``, four words (the
    counters ``(0, i)``, as :func:`random_bits` draws them)."""
    k0, k1 = (int(w) & _MASK for w in torch.as_tensor(key).reshape(2).tolist())
    return tuple(a ^ b for a, b in (_threefry_int(k0, k1, 0, i) for i in range(4)))


def rbg_fold_in(key: Sequence[int], data: int) -> Tuple[int, int, int, int]:
    """``jax.random.fold_in`` of an ``rbg`` key (``_rbg_fold_in``,
    ``jax/_src/prng.py``): threefry's ``fold_in`` on each two-word half."""
    d = int(data) & _MASK
    return (*_threefry_int(key[0], key[1], 0, d), *_threefry_int(key[2], key[3], 0, d))


def _philox_rounds(k0, k1, c, mulhilo, wrap):
    """Ten Philox4x32 rounds of the counter words ``c`` (four arrays) under
    the key ``(k0, k1)``; ``mulhilo(a, m)`` gives the high and low words of
    ``a * m``."""
    c0, c1, c2, c3 = c
    for _ in range(10):
        hi0, lo0 = mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = wrap(k0 + PHILOX_W[0]), wrap(k1 + PHILOX_W[1])
    return c0, c1, c2, c3


def _philox_host(key: Sequence[int], first: int, blocks: int) -> np.ndarray:
    """Blocks ``first .. first + blocks - 1`` of the stream as numpy
    uint32, ``(blocks, 4)``."""
    i = np.arange(blocks, dtype=np.uint64) + np.uint64(first)
    base = key[2] | (key[3] << 32)
    lo = i + np.uint64(base)  # the 128-bit counter's low half, wrapping
    carry = (lo < i).astype(np.uint64)
    hi = np.uint64(key[0] | (key[1] << 32)) + carry
    c = tuple(w & np.uint64(_MASK) for w in (lo, lo >> np.uint64(32), hi, hi >> np.uint64(32)))

    def mulhilo(a, m):
        p = a * np.uint64(m)
        return p >> np.uint64(32), p & np.uint64(_MASK)

    out = _philox_rounds(np.uint64(key[0]), np.uint64(key[1]), c, mulhilo,
                         lambda v: v & np.uint64(_MASK))
    return np.stack(out, axis=-1).astype(np.uint32)


def _philox_device(key: Sequence[int], first: int, blocks: int, device) -> torch.Tensor:
    """The same blocks as int64 torch ops masked to 32 bits on ``device``.
    A 32x32-bit product overflows a signed int64 and wraps: its high word
    is masked after the shift."""
    i = torch.arange(blocks, dtype=torch.int64, device=device) + first
    w0 = i & _MASK
    w0 = w0 + key[2]
    w1 = (i >> 32) + key[3] + (w0 >> 32)
    w2 = key[0] + (w1 >> 32)
    w3 = key[1] + (w2 >> 32)
    c = tuple(w & _MASK for w in (w0, w1, w2, w3))

    def mulhilo(a, m):
        p = a * m
        return (p >> 32) & _MASK, p & _MASK

    out = _philox_rounds(key[0], key[1], c, mulhilo, lambda v: v & _MASK)
    return torch.stack(out, dim=-1)


def philox_bits(key: Sequence[int], n: int, offset: int = 0, device=None) -> torch.Tensor:
    """Words ``offset .. offset + n - 1`` of ``jax.random.bits`` on the
    ``rbg`` key ``key`` (four words), as XLA's CPU backend draws them: int64
    of uint32 values, flat, on ``device``.

    The stream is Philox4x32-10 under the key ``(k0, k1)``; block ``i``
    encrypts the 128-bit counter ``C + i``, where ``C`` holds the words
    ``(k2, k3, k0, k1)`` from low to high (the u64[2] state reversed), and
    word ``j`` of a tensor's flat order is word ``j % 4`` of block
    ``j // 4``. For the CPU, and up to ``HOST_WORDS`` words for a card, it
    runs on the host in numpy (some 15x faster there than int64 torch
    ops); more words for a card run as torch ops on the card."""
    key = tuple(int(k) & _MASK for k in key)
    device = torch.device("cpu") if device is None else torch.device(device)
    first, last = offset // 4, (offset + n + 3) // 4
    if n <= HOST_WORDS or device.type == "cpu":
        words = _philox_host(key, first, last - first).reshape(-1)
        words = torch.from_numpy(words.astype(np.int64))
        return to_device(words[offset % 4:offset % 4 + n], device)
    words = _philox_device(key, first, last - first, device).reshape(-1)
    return words[offset % 4:offset % 4 + n]
