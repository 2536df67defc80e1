"""A numpy writer and reader of BMP files. The writer writes 8-bit
grayscale BMP, the format PIL writes for a mode ``L`` image (the JAX
package's evaluate writes its prediction BMPs with PIL, which the card's
machine may not have). The reader takes what PIL writes for modes ``L``
and ``RGB``: uncompressed 8-bit BMP with a grey palette, and 24-bit BMP;
it raises on the rest."""

from __future__ import annotations

import struct

import numpy as np

_PALETTE = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
_PALETTE[:, 3] = 0  # (blue, green, red, reserved) per grey level
_PPM = int(96 * 39.3701 + 0.5)  # PIL's default 96 dpi in pixels per metre


def save_bmp_gray(path: str, image: np.ndarray) -> None:
    """Write a 2D uint8 array as an uncompressed 8-bit BMP with a grey
    palette, the bytes PIL writes for a mode ``L`` image: a 14-byte file
    header, a 40-byte BITMAPINFOHEADER (96 dpi, 256 colours used and
    important), 256 palette entries, then the rows bottom-up, each padded to
    a multiple of 4 bytes."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"need a 2D uint8 array, got {image.shape} {image.dtype}")
    h, w = image.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = image[::-1]
    offset = 14 + 40 + _PALETTE.nbytes
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", offset + rows.nbytes, 0, 0, offset))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.nbytes, _PPM, _PPM, 256, 256))
        f.write(_PALETTE.tobytes())
        f.write(rows.tobytes())


def read_bmp(path: str) -> np.ndarray:
    """The pixels as PIL's ``np.asarray(Image.open(path))`` gives them: (H,
    W) uint8 grey levels for an 8-bit BMP whose palette is grey, (H, W, 3)
    uint8 RGB for a 24-bit BMP. Rows stored bottom-up or top-down; other
    depths, compression or a colour palette raise."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack_from("<I", buf, 10)
    hsize, w, h, planes, bits, comp = struct.unpack_from("<IiiHHI", buf, 14)
    if hsize < 40 or comp != 0:
        raise ValueError(f"{path}: only uncompressed BMP with a BITMAPINFOHEADER is supported")
    if bits not in (8, 24):
        raise ValueError(f"{path}: {bits}-bit BMP is not supported (8 and 24 are)")
    bottom_up, h = h > 0, abs(h)
    stride = (w * bits // 8 + 3) & ~3
    rows = np.frombuffer(buf, np.uint8, h * stride, offset).reshape(h, stride)
    if bottom_up:
        rows = rows[::-1]
    if bits == 24:
        return np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1])
    (n_colors,) = struct.unpack_from("<I", buf, 46)
    n_colors = n_colors or 256
    palette = np.frombuffer(buf, np.uint8, 4 * n_colors, 14 + hsize).reshape(n_colors, 4)
    if not (np.array_equal(palette[:, 0], palette[:, 1])
            and np.array_equal(palette[:, 1], palette[:, 2])):
        raise ValueError(f"{path}: 8-bit BMP with a colour palette is not supported")
    return palette[:, 0][rows[:, :w]]
