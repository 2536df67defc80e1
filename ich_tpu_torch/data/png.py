"""Grayscale 8-bit PNG files with numpy, ``zlib`` and ``struct`` (no PIL).

:func:`save_png_gray` writes an (H, W) uint8 image as a PNG of colour type
0 and bit depth 8: one IDAT chunk, every row with filter 0. The bytes differ
from PIL's (which picks filters and compression of its own); the pixels do
not, and :func:`read_png_gray` reads them back. The reader takes
non-interlaced 8-bit grayscale files with any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png_gray(path: str, img: np.ndarray) -> None:
    """Write ``img`` (H, W) uint8 to ``path`` as a grayscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"save_png_gray wants (H, W) uint8; got {img.shape} {img.dtype}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)  # filter byte 0 a row
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) uint8 pixels of an 8-bit grayscale, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale non-interlaced PNGs are read "
                         f"(depth {depth}, colour type {colour}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.int32)
    prev = np.zeros(w, np.int32)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 2:
            cur = (row + prev) & 0xFF
        elif kind in (1, 3, 4):
            cur = np.zeros(w, np.int32)
            for x in range(w):  # left neighbours are decoded in order
                left = cur[x - 1] if x else 0
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + prev[x]) // 2
                else:
                    pred = _paeth(np.int32(left), prev[x], prev[x - 1] if x else np.int32(0))
                cur[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)
