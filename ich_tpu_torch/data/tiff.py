"""A numpy reader and writer of uncompressed baseline TIFF, the files PIL
writes for a single-channel image (the SegICH 2D CT slices are mode ``F``
TIFFs), so that the port reads them without PIL.

The reader takes little-endian (``II``) files with one image, one sample
per pixel, no compression and the rows in strips: PIL's modes ``F``
(float32), ``I`` (int32), ``I;16`` (uint16) and ``L`` (uint8). It raises on
anything else: big-endian files, compression, a predictor, tiles, several
samples per pixel. The writer writes those four types in one strip, with
the tags PIL writes.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# TIFF field types SHORT and LONG: (struct code, size)
_TYPES = {3: ("H", 2), 4: ("I", 4)}
# (BitsPerSample, SampleFormat) -> dtype of PIL's modes L, I;16, I and F;
# SampleFormat 1 unsigned, 2 signed, 3 float
_DTYPES = {(8, 1): np.uint8, (16, 1): np.uint16, (32, 2): np.int32, (32, 3): np.float32}
_FORMATS = {np.dtype(v): k for k, v in _DTYPES.items()}


def _ifd(buf: bytes) -> Dict[int, Tuple[int, ...]]:
    """The first image file directory: tag -> tuple of values."""
    if buf[:4] != b"II*\x00":
        raise ValueError("not a little-endian TIFF (the reader takes only 'II' files)")
    (off,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, off)
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from("<HHI4s", buf, off + 2 + 12 * i)
        if typ not in _TYPES:
            continue  # rationals, ASCII, bytes: no tag the pixels depend on
        code, size = _TYPES[typ]
        data = value if count * size <= 4 else buf[struct.unpack("<I", value)[0]:][:count * size]
        tags[tag] = struct.unpack_from(f"<{count}{code}", data)
    return tags


def read_tiff(path: str) -> np.ndarray:
    """The (H, W) array of an uncompressed single-sample strip TIFF."""
    with open(path, "rb") as f:
        buf = f.read()
    tags = _ifd(buf)

    def one(tag, default=None):
        v = tags.get(tag, (default,))
        if v[0] is None:
            raise ValueError(f"{path}: TIFF tag {tag} missing")
        return v[0]

    w, h = one(256), one(257)
    if one(259, 1) != 1:
        raise ValueError(f"{path}: compressed TIFF (compression {one(259)}) is not supported")
    if one(317, 1) != 1:
        raise ValueError(f"{path}: TIFF predictor is not supported")
    if one(277, 1) != 1:
        raise ValueError(f"{path}: {one(277)} samples per pixel; only 1 is supported")
    if 322 in tags or 324 in tags:
        raise ValueError(f"{path}: tiled TIFF is not supported")
    bits, fmt = one(258, 1), one(339, 1)
    if (bits, fmt) not in _DTYPES:
        raise ValueError(f"{path}: {bits}-bit samples of format {fmt} are not supported")
    dtype = np.dtype(_DTYPES[(bits, fmt)]).newbyteorder("<")
    offsets, counts = tags[273], tags[279]
    data = b"".join(buf[o:o + c] for o, c in zip(offsets, counts))
    n = h * w * dtype.itemsize
    if len(data) < n:
        raise ValueError(f"{path}: strips hold {len(data)} bytes, the image needs {n}")
    return np.frombuffer(data[:n], dtype=dtype).reshape(h, w).astype(dtype.newbyteorder("="))


def write_tiff(path: str, image: np.ndarray) -> None:
    """Write a 2D float32, int32, uint16 or uint8 array as PIL writes it
    for mode ``F``, ``I``, ``I;16`` or ``L``: a little-endian TIFF with the
    pixels in one strip after a directory of the tags PIL writes."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype not in (np.float32, np.int32, np.uint16, np.uint8):
        raise ValueError(f"need a 2D float32/int32/uint16/uint8 array, got {image.shape} "
                         f"{image.dtype}")
    h, w = image.shape
    bits, fmt = _FORMATS[image.dtype]
    pixels = np.ascontiguousarray(image, dtype=image.dtype.newbyteorder("<")).tobytes()
    entries = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1), (262, 3, 1),
               (273, 4, 0), (277, 3, 1), (278, 4, h), (279, 4, len(pixels)), (284, 3, 1)]
    if fmt != 1:
        entries.append((339, 3, fmt))
    ifd_size = 2 + 12 * len(entries) + 4
    data_offset = 8 + ifd_size
    out = bytearray(b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", len(entries)))
    for tag, typ, value in entries:
        value = data_offset if tag == 273 else value
        code = _TYPES[typ][0]
        out += struct.pack("<HHI", tag, typ, 1) + struct.pack(f"<{code}", value).ljust(4, b"\x00")
    out += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(bytes(out) + pixels)
