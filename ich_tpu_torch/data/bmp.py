"""A numpy writer of 8-bit grayscale BMP files, the format PIL writes for a
mode ``L`` image (the JAX package's evaluate writes its prediction BMPs
with PIL, which the card's machine may not have)."""

from __future__ import annotations

import struct

import numpy as np

_PALETTE = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
_PALETTE[:, 3] = 0  # (blue, green, red, reserved) per grey level


def save_bmp_gray(path: str, image: np.ndarray) -> None:
    """Write a 2D uint8 array as an uncompressed 8-bit BMP with a grey
    palette: a 14-byte file header, a 40-byte BITMAPINFOHEADER, 256 palette
    entries, then the rows bottom-up, each padded to a multiple of 4 bytes."""
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
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.nbytes, 0, 0, 256, 0))
        f.write(_PALETTE.tobytes())
        f.write(rows.tobytes())
