"""The random draws that the timed paths make from their keys, worked out
again on the host in numpy, so that the reference sees the inputs the
program's steps saw without calling the program.

A frozen copy of the algorithms of ``ich_tpu_torch/utils/rng.py``
(jax.random's threefry2x32 with ``jax_threefry_partitionable`` on, the
fold-like ``split``, ``bits``, ``uniform``, ``bernoulli`` and ``randint``
of ``jax/_src/prng.py`` and ``jax/_src/random.py``, Apache-2.0) and of
XLA's Philox4x32-10 expansion of ``rng_bit_generator`` (its
``lib/prng.cc``), with flax's key folding (``flax/core/scope.py``,
Apache-2.0). A key is a uint32 numpy array ``(..., 2)``.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry(k0, k1, x0, x1):
    """threefry2x32's 20 rounds on uint32 arrays (or Python ints, masked)."""
    if isinstance(x0, int):
        wrap = lambda v: v & _MASK  # noqa: E731
    else:
        wrap = lambda v: v  # noqa: E731  (uint32 arrays wrap by themselves)
    ks = (k0, k1, k0 ^ k1 ^ (_PARITY if isinstance(k0, int) else np.uint32(_PARITY)))
    x0, x1 = wrap(x0 + k0), wrap(x1 + k1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            if isinstance(x1, int):
                x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
            else:
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        inc = i + 1 if isinstance(x1, int) else np.uint32(i + 1)
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + inc)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` outside x64 mode."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def _words(key: np.ndarray, shape: Tuple[int, ...]):
    """threefry2x32 of each key over the flat index of ``shape``:
    ``key.shape[:-1] + shape`` twice."""
    batch = key.shape[:-1]
    n = int(np.prod(shape, dtype=np.int64))
    k = key.reshape(batch + (1,) * len(shape) + (2,))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    full = batch + tuple(shape)
    hi = np.broadcast_to((idx >> np.uint64(32)).astype(np.uint32), full).copy()
    lo = np.broadcast_to(idx.astype(np.uint32), full).copy()
    k0 = np.broadcast_to(k[..., 0], full).copy()
    k1 = np.broadcast_to(k[..., 1], full).copy()
    with np.errstate(over="ignore"):
        return _threefry(k0, k1, hi, lo)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    k0, k1 = (int(w) for w in key.reshape(2))
    return np.array(_threefry(k0, k1, 0, int(data) & _MASK), dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``key.shape[:-1] + (num, 2)``."""
    b0, b1 = _words(np.asarray(key, np.uint32), (int(num),))
    return np.stack([b0, b1], axis=-1)


def bits(key: np.ndarray, shape: Sequence[int] = ()) -> np.ndarray:
    b0, b1 = _words(np.asarray(key, np.uint32), tuple(shape))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """float32 ``max(lo, u (hi - lo) + lo)``, the product and sum rounded
    once, as XLA's CPU backend fuses them."""
    u = ((bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - 1.0
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float32(hi32 - lo32)
    out = (u.astype(np.float64) * np.float64(span) + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, out)


def bernoulli(key: np.ndarray, p: float, shape: Sequence[int]) -> np.ndarray:
    return uniform(key, shape) < np.float32(p)


def randint(key: np.ndarray, shape: Sequence[int], lo, hi) -> np.ndarray:
    """int32 ``jax.random.randint``: two words a value from the halves of
    ``split(key)``, reduced modulo the span in wrapping uint32 arithmetic."""
    key = np.asarray(key, np.uint32)
    both = bits(split(key), shape)  # key.shape[:-1] + (2,) + shape
    higher = np.take(both, 0, axis=key.ndim - 1).astype(np.int64)
    lower = np.take(both, 1, axis=key.ndim - 1).astype(np.int64)
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    span = np.where(hi <= lo, 1, (hi - lo) & _MASK)
    mult = ((65536 % span) ** 2 & _MASK) % span
    off = (((higher % span) * mult & _MASK) + lower % span) & _MASK
    return lo + off % span


# -- dropout: the rbg key and XLA's Philox stream ---------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def flax_fold(path: Sequence[str], counter: int) -> int:
    """The word flax folds into a scope's key: SHA-1 of the path names and
    the ``make_rng`` counter, first 4 bytes big endian."""
    m = hashlib.sha1()
    for x in tuple(path) + (counter,):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def dropout_rbg_key(step_drop_key: np.ndarray, path: Sequence[str]) -> Tuple[int, ...]:
    """The rbg key of the Dropout at flax scope ``path`` under the step's
    dropout key: ``bits(key, (4,))``, then threefry's ``fold_in`` of each
    half with the scope's fold word."""
    k0, k1 = (int(w) for w in np.asarray(step_drop_key).reshape(2))
    rbg = [a ^ b for a, b in (_threefry(k0, k1, 0, i) for i in range(4))]
    d = flax_fold(path, 1)
    return (*_threefry(rbg[0], rbg[1], 0, d), *_threefry(rbg[2], rbg[3], 0, d))


def philox_bits(key: Sequence[int], n: int, device) -> torch.Tensor:
    """Words ``0 .. n - 1`` of XLA's Philox4x32-10 stream under the rbg
    ``key``: block ``i`` encrypts the 128-bit counter ``(k2, k3, k0, k1) +
    i`` under ``(k0, k1)``; word ``j`` is word ``j % 4`` of block ``j // 4``.
    int64 of uint32 values on ``device``, in int64 torch ops."""
    key = tuple(int(k) & _MASK for k in key)
    blocks = (n + 3) // 4
    i = torch.arange(blocks, dtype=torch.int64, device=device)
    w0 = (i & _MASK) + key[2]
    w1 = (i >> 32) + key[3] + (w0 >> 32)
    w2 = key[0] + (w1 >> 32)
    w3 = key[1] + (w2 >> 32)
    c0, c1, c2, c3 = (w & _MASK for w in (w0, w1, w2, w3))
    k0, k1 = key[0], key[1]
    for _ in range(10):
        p0 = c0 * PHILOX_M[0]
        p1 = c2 * PHILOX_M[1]
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK, (k1 + PHILOX_W[1]) & _MASK
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(-1)[:n]

