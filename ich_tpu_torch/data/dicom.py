"""Minimal pure-python DICOM reader for CT slices, copied from
``ich_tpu/data/dicom.py`` (importing ``ich_tpu.data`` imports jax).

The reference reads RSNA/CQ500 DICOMs with pydicom
(``datasets.py:393-394``: ``pixel_array * RescaleSlope + RescaleIntercept``;
``qureAI_extract_as_nifti.py``); this module needs no pydicom and parses
the subset the pipelines need: uncompressed little-endian (implicit or
explicit VR) single-frame images with the standard CT tags —
Rows/Columns, BitsAllocated, PixelRepresentation, RescaleSlope/Intercept,
PixelSpacing, SliceThickness, ImagePositionPatient, PixelData. Compressed
transfer syntaxes raise a clear error.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# (group, element) -> name
_TAGS = {
    (0x0008, 0x0018): "SOPInstanceUID",
    (0x0010, 0x0020): "PatientID",
    (0x0018, 0x0050): "SliceThickness",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x7FE0, 0x0010): "PixelData",
}

_UNCOMPRESSED = {
    "1.2.840.10008.1.2",        # implicit VR little endian
    "1.2.840.10008.1.2.1",      # explicit VR little endian
}

# VRs with 2-byte reserved + 4-byte length in explicit mode
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}


class DicomError(ValueError):
    pass


def _parse_elements(buf: bytes, offset: int, explicit: bool) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, offset)
        offset += 4
        if explicit or group == 0x0002:
            vr = buf[offset : offset + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from("<H", buf, offset + 2)[0]
                offset += 4
        else:
            length = struct.unpack_from("<I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:
            raise DicomError("undefined-length element (compressed/sequence) unsupported")
        name = _TAGS.get((group, elem))
        if name is not None:
            out[name] = buf[offset : offset + length]
        if group == 0x7FE0 and elem == 0x0010:
            break  # pixel data is last thing we need
        offset += length
    return out


def _meta_and_body(buf: bytes) -> Tuple[str, int]:
    """Parse the file-meta group; return (transfer_syntax, body_offset)."""
    if buf[128:132] != b"DICM":
        # some files omit the preamble; try from 0 as implicit LE
        return "1.2.840.10008.1.2", 0
    offset = 132
    ts = "1.2.840.10008.1.2.1"
    # file meta group (0002,xxxx) is always explicit little endian
    while offset + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, offset)
        if group != 0x0002:
            break
        vr = buf[offset + 4 : offset + 6]
        if vr in _LONG_VRS:
            length = struct.unpack_from("<I", buf, offset + 8)[0]
            val_off = offset + 12
        else:
            length = struct.unpack_from("<H", buf, offset + 6)[0]
            val_off = offset + 8
        if (group, elem) == (0x0002, 0x0010):
            ts = buf[val_off : val_off + length].decode("ascii").strip("\x00 ")
        offset = val_off + length
    return ts, offset


def _decode_number(raw: bytes, default: float = 0.0) -> float:
    try:
        return float(raw.decode("ascii").strip("\x00 ").split("\\")[0])
    except Exception:
        return default


def _decode_numbers(raw: bytes) -> List[float]:
    try:
        return [float(x) for x in raw.decode("ascii").strip("\x00 ").split("\\")]
    except Exception:
        return []


def read_dicom(path: str) -> Dict:
    """Read one DICOM file → dict with 'pixel_array' (raw stored values),
    'RescaleSlope', 'RescaleIntercept', spatial metadata."""
    with open(path, "rb") as f:
        buf = f.read()
    ts, body = _meta_and_body(buf)
    if ts not in _UNCOMPRESSED:
        raise DicomError(f"{path}: transfer syntax {ts} not supported (compressed?)")
    explicit = ts == "1.2.840.10008.1.2.1"
    el = _parse_elements(buf, body, explicit)
    if "PixelData" not in el or "Rows" not in el:
        raise DicomError(f"{path}: missing PixelData/Rows")
    rows = struct.unpack("<H", el["Rows"][:2])[0]
    cols = struct.unpack("<H", el["Columns"][:2])[0]
    bits = struct.unpack("<H", el.get("BitsAllocated", b"\x10\x00")[:2])[0]
    signed = struct.unpack("<H", el.get("PixelRepresentation", b"\x00\x00")[:2])[0] == 1
    if bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 8:
        dtype = np.int8 if signed else np.uint8
    else:
        raise DicomError(f"{path}: BitsAllocated {bits} unsupported")
    pix = np.frombuffer(el["PixelData"], dtype=dtype, count=rows * cols).reshape(rows, cols)
    return {
        "pixel_array": pix,
        "RescaleSlope": _decode_number(el.get("RescaleSlope", b"1"), 1.0),
        "RescaleIntercept": _decode_number(el.get("RescaleIntercept", b"0"), 0.0),
        "PixelSpacing": _decode_numbers(el.get("PixelSpacing", b"")),
        "SliceThickness": _decode_number(el.get("SliceThickness", b"0"), 0.0),
        "ImagePositionPatient": _decode_numbers(el.get("ImagePositionPatient", b"")),
        "SeriesInstanceUID": el.get("SeriesInstanceUID", b"").decode("ascii", "ignore").strip("\x00 "),
        "PatientID": el.get("PatientID", b"").decode("ascii", "ignore").strip("\x00 "),
    }


def read_ct_hu(path: str) -> np.ndarray:
    """CT slice in Hounsfield units: pixel_array * slope + intercept
    (reference ``datasets.py:393-394``)."""
    d = read_dicom(path)
    return d["pixel_array"].astype(np.float32) * d["RescaleSlope"] + d["RescaleIntercept"]


def series_to_volume(paths: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a DICOM series into an (H, W, Z) HU volume sorted by z position
    + a 4x4 affine from spacing/position (the reference's
    ``qureAI_extract_as_nifti.py`` behavior)."""
    items = []
    for p in paths:
        d = read_dicom(p)
        z = d["ImagePositionPatient"][2] if len(d["ImagePositionPatient"]) == 3 else len(items)
        hu = d["pixel_array"].astype(np.float32) * d["RescaleSlope"] + d["RescaleIntercept"]
        items.append((z, hu, d))
    items.sort(key=lambda t: t[0])
    vol = np.stack([hu for _, hu, _ in items], axis=2)
    d0 = items[0][2]
    sp = d0["PixelSpacing"] or [1.0, 1.0]
    dz = (items[1][0] - items[0][0]) if len(items) > 1 else (d0["SliceThickness"] or 1.0)
    affine = np.diag([sp[0], sp[1], dz, 1.0])
    if len(d0["ImagePositionPatient"]) == 3:
        affine[:3, 3] = d0["ImagePositionPatient"]
    return vol, affine


def write_minimal_dicom(
    path: str,
    pixels: np.ndarray,
    slope: float = 1.0,
    intercept: float = 0.0,
    spacing: Tuple[float, float] = (1.0, 1.0),
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> None:
    """Write a minimal explicit-VR-LE DICOM (testing / interchange)."""
    pixels = np.asarray(pixels, dtype=np.int16)
    rows, cols = pixels.shape

    def elem(group, el, vr, value: bytes) -> bytes:
        if len(value) % 2:
            value += b"\x00"
        head = struct.pack("<HH", group, el) + vr
        if vr in _LONG_VRS:
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    meta_body = elem(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    meta = elem(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    body = b"".join(
        [
            elem(0x0018, 0x0050, b"DS", b"1.0"),
            elem(0x0020, 0x0032, b"DS", "\\".join(str(p) for p in position).encode()),
            elem(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            elem(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            elem(0x0028, 0x0030, b"DS", f"{spacing[0]}\\{spacing[1]}".encode()),
            elem(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            elem(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
            elem(0x0028, 0x1052, b"DS", str(intercept).encode()),
            elem(0x0028, 0x1053, b"DS", str(slope).encode()),
            elem(0x7FE0, 0x0010, b"OW", pixels.tobytes()),
        ]
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
