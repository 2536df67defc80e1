# Copied verbatim from ich_tpu/data/nifti.py (framework-free; importing it there pulls in jax).
"""Minimal pure-numpy NIfTI-1 reader/writer.

The reference uses nibabel for volume I/O (``datasets.py:174-248``,
``UNet2D.py:272-314``); nibabel is not available in this image, and volume
decode is a host-side concern anyway, so this module implements the NIfTI-1
format directly: ``.nii`` / ``.nii.gz``, sform/qform affines, scl slope /
intercept scaling — everything the reference's pipelines touch.

Format: NIfTI-1 (348-byte header), https://nifti.nimh.nih.gov/nifti-1.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = float(np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d))))
    qfac = -1.0 if hdr["pixdim"][0] == -1 else 1.0
    dx, dy, dz = hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    aff = np.eye(4)
    aff[:3, :3] = R * np.array([dx, dy, dz])
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def read_header(path: str) -> dict:
    with _open(path, "rb") as f:
        raw = f.read(HEADER_SIZE)
    return _parse_header(raw, path)


def _parse_header(raw: bytes, path: str) -> dict:
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        endian = ">"
    u = lambda fmt, off: struct.unpack(endian + fmt, raw[off : off + struct.calcsize(fmt)])
    hdr = {
        "endian": endian,
        "dim": u("8h", 40),
        "datatype": u("h", 70)[0],
        "bitpix": u("h", 72)[0],
        "pixdim": u("8f", 76),
        "vox_offset": u("f", 108)[0],
        "scl_slope": u("f", 112)[0],
        "scl_inter": u("f", 116)[0],
        "qform_code": u("h", 252)[0],
        "sform_code": u("h", 254)[0],
        "quatern_b": u("f", 256)[0],
        "quatern_c": u("f", 260)[0],
        "quatern_d": u("f", 264)[0],
        "qoffset_x": u("f", 268)[0],
        "qoffset_y": u("f", 272)[0],
        "qoffset_z": u("f", 276)[0],
        "srow_x": u("4f", 280),
        "srow_y": u("4f", 296),
        "srow_z": u("4f", 312),
        "magic": raw[344:348],
    }
    return hdr


def affine_from_header(hdr: dict) -> np.ndarray:
    if hdr["sform_code"] > 0:
        aff = np.eye(4)
        aff[0], aff[1], aff[2] = hdr["srow_x"], hdr["srow_y"], hdr["srow_z"]
        return aff
    if hdr["qform_code"] > 0:
        return _quaternion_affine(hdr)
    aff = np.diag([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3], 1.0])
    return aff


def load(
    path: str, dtype: Optional[np.dtype] = None, apply_scaling: bool = True
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Load a .nii/.nii.gz volume. Returns (data, affine, header).

    Data has the file's spatial dims (Fortran-ordered like nibabel); scale
    slope/intercept are applied (→ float32) when present, matching
    ``nibabel.get_fdata`` semantics.
    """
    # one pass over the (possibly gzip) stream: header, skip to
    # vox_offset, voxels — a separate read_header() + seek() decompresses
    # a .nii.gz from the start twice per volume
    with _open(path, "rb") as f:
        hdr = _parse_header(f.read(HEADER_SIZE), path)
        ndim = hdr["dim"][0]
        shape = tuple(int(s) for s in hdr["dim"][1 : 1 + ndim])
        np_dtype = _DTYPES.get(hdr["datatype"])
        if np_dtype is None:
            raise ValueError(f"{path}: unsupported NIfTI datatype {hdr['datatype']}")
        count = int(np.prod(shape))
        skip = int(hdr["vox_offset"]) - HEADER_SIZE
        if skip > 0:
            f.read(skip)
        buf = f.read(count * np.dtype(np_dtype).itemsize)
    # bytearray: callers get a WRITABLE array (np.frombuffer over the raw
    # bytes is read-only — an in-place `vol *= mask` would raise)
    data = np.frombuffer(bytearray(buf), dtype=np.dtype(np_dtype).newbyteorder(hdr["endian"]))
    data = data[:count].reshape(shape, order="F")
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    # NIfTI-1 spec: scl_slope == 0 means "no scaling" — BOTH fields are
    # ignored (a garbage scl_inter in such files must not shift the HU)
    if apply_scaling and slope != 0.0 and (slope != 1.0 or inter != 0.0):
        data = data.astype(np.float32) * slope + inter
    if dtype is not None:
        data = data.astype(dtype)
    return np.asarray(data), affine_from_header(hdr), hdr


def pixdim(hdr_or_affine) -> np.ndarray:
    """Voxel spacing (dx, dy, dz)."""
    if isinstance(hdr_or_affine, dict):
        return np.asarray(hdr_or_affine["pixdim"][1:4])
    aff = np.asarray(hdr_or_affine)
    return np.sqrt((aff[:3, :3] ** 2).sum(axis=0))


def save(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None) -> None:
    """Write a .nii/.nii.gz single-file NIfTI-1 volume with an sform affine."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    pd = [1.0] + list(spacing) + [0.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
