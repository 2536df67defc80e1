"""The port's native loader (``ich_tpu_torch.native``, C++ built with g++
into ``build/ich_tpu_torch/``): the cases of ``tests/test_native.py`` run
against it, the malformed-header rejections included, with the port's
Python NIfTI codec and window + resize as the reference; and the volumes
it decodes equal to the JAX package's native loader's."""

import fcntl
import os
import shutil
import time

import numpy as np
import pytest
import torch

from ich_tpu import native as jax_native
from ich_tpu_torch import native
from ich_tpu_torch.data import nifti
from ich_tpu_torch.kernels._build import BUILD_DIR
from ich_tpu_torch.ops import ct


@pytest.fixture(autouse=True)
def built():
    """The library, built here; a machine without g++ cannot build it."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native loader cannot be built")
    assert native.available(), native._error


def _load_jax_native(timeout: float = 120.0):
    """The JAX package's native library, loaded once it is whole.

    Each test process that imports ``tests/test_native.py`` builds
    ``ich_tpu/native/libfastload.so`` to the same path, and under xdist
    they do so at once: a process that loads a file another one is still
    writing marks the build failed for good ("file too short"). So, under
    a lock that these loads share, wait until the file stops growing,
    clear that mark and load once more (which builds the library where
    there is none). Raises if the library cannot be built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "ich_tpu_fastload.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if jax_native._lib is None:
                size, deadline = -1, time.monotonic() + timeout
                while os.path.exists(jax_native._LIB) and time.monotonic() < deadline:
                    now = os.path.getsize(jax_native._LIB)
                    if now == size:
                        break
                    size = now
                    time.sleep(0.5)
                jax_native._build_failed = False
            if not jax_native.available():
                raise RuntimeError(f"the JAX package's native library cannot be built "
                                   f"from {jax_native._SRC}")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return jax_native


def test_native_nifti_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    vol = rng.uniform(-100, 200, size=(24, 20, 12)).astype(np.float32)
    fn = str(tmp_path / "v.nii")
    nifti.save(fn, vol, np.diag([0.5, 0.5, 2.5, 1.0]))
    got, pixdim = native.load_nifti_f32(fn)
    want, _, hdr = nifti.load(fn)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(pixdim, [0.5, 0.5, 2.5], atol=1e-5)


def test_native_nifti_gzip(tmp_path):
    rng = np.random.default_rng(1)
    vol = (rng.uniform(0, 100, size=(8, 8, 4))).astype(np.float32)
    fn = str(tmp_path / "v.nii.gz")
    nifti.save(fn, vol)
    got, _ = native.load_nifti_f32(fn)
    np.testing.assert_allclose(got, vol, atol=1e-5)


def test_native_int16_with_scaling(tmp_path):
    vol = np.arange(-50, 50, dtype=np.int16).reshape(10, 10)
    fn = str(tmp_path / "s.nii")
    nifti.save(fn, vol)
    got, _ = native.load_nifti_f32(fn)
    np.testing.assert_allclose(got, vol.astype(np.float32))


def _raw_nifti(dims, datatype, bitpix, vox_offset, payload: bytes) -> bytes:
    """Hand-craft a minimal little-endian NIfTI-1 blob (no magic check)."""
    import struct

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [len(dims)] + list(dims) + [1] * (7 - len(dims))
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)
    struct.pack_into("<f", hdr, 108, vox_offset)
    struct.pack_into("<ff", hdr, 112, 1.0, 0.0)
    pad = b"\x00" * max(0, int(vox_offset) - 348) if np.isfinite(vox_offset) else b"\x00" * 4
    return bytes(hdr) + pad + payload


def test_native_rejects_lying_bitpix(tmp_path):
    """A corrupt header claiming datatype=float64 but bitpix=8 must NOT pass
    the bounds check with the 1-byte element size (heap over-read guard)."""
    fn = str(tmp_path / "evil.nii")
    # 64 elems, payload only 64 bytes — float64 needs 512
    with open(fn, "wb") as f:
        f.write(_raw_nifti((4, 4, 4), datatype=64, bitpix=8,
                           vox_offset=352.0, payload=b"\x01" * 64))
    with pytest.raises(IOError):
        native.load_nifti_f32(fn)


def test_native_rejects_bad_vox_offset(tmp_path):
    for off in (float("nan"), 0.0, -4.0):
        fn = str(tmp_path / "off.nii")
        with open(fn, "wb") as f:
            f.write(_raw_nifti((2, 2), datatype=2, bitpix=8,
                               vox_offset=off, payload=b"\x01" * 64))
        with pytest.raises(IOError):
            native.load_nifti_f32(fn)


def test_native_rejects_nonpositive_dim(tmp_path):
    fn = str(tmp_path / "dim.nii")
    with open(fn, "wb") as f:
        f.write(_raw_nifti((4, -4, 4), datatype=2, bitpix=8,
                           vox_offset=352.0, payload=b"\x01" * 64))
    with pytest.raises(IOError):
        native.load_nifti_f32(fn)


def test_native_rejects_overflowing_dims(tmp_path):
    """dims whose product wraps uint64 (16384^4 * 4 bytes ≡ 0 mod 2^64)
    must be rejected by the element cap, not pass the bounds check."""
    fn = str(tmp_path / "wrap.nii")
    with open(fn, "wb") as f:
        f.write(_raw_nifti((16384, 16384, 16384, 16384), datatype=16,
                           bitpix=32, vox_offset=352.0, payload=b"\x01" * 64))
    with pytest.raises(IOError):
        native.load_nifti_f32(fn)


def test_native_vox_offset_348_legacy_accepted_mid_flag_rejected(tmp_path):
    """Legacy extension-less writers emit vox_offset=348 (data abuts the
    header) — accepted (ADVICE r2). Offsets strictly inside (348, 352)
    would start the payload mid-extension-flag and stay rejected."""
    fn = str(tmp_path / "legacy.nii")
    with open(fn, "wb") as f:
        f.write(_raw_nifti((2, 2), datatype=2, bitpix=8,
                           vox_offset=348.0, payload=b"\x07" * 64))
    vol, _ = native.load_nifti_f32(fn)
    assert vol.shape == (2, 2)
    np.testing.assert_array_equal(vol, np.full((2, 2), 7.0, np.float32))

    fn2 = str(tmp_path / "midflag.nii")
    with open(fn2, "wb") as f:
        f.write(_raw_nifti((2, 2), datatype=2, bitpix=8,
                           vox_offset=350.0, payload=b"\x01" * 64))
    with pytest.raises(IOError):
        native.load_nifti_f32(fn2)


def test_native_float64_roundtrip(tmp_path):
    """Legit float64 volumes still decode (element size from datatype)."""
    vol = np.linspace(-10, 10, 24).reshape(2, 3, 4)
    fn = str(tmp_path / "f64.nii")
    with open(fn, "wb") as f:
        f.write(_raw_nifti((2, 3, 4), datatype=64, bitpix=64, vox_offset=352.0,
                           payload=vol.astype("<f8").tobytes(order="F")))
    got, _ = native.load_nifti_f32(fn)
    np.testing.assert_allclose(got, vol.astype(np.float32), atol=1e-6)


def test_window_resize_matches_python():
    rng = np.random.default_rng(2)
    slices = rng.uniform(-200, 300, size=(5, 40, 40)).astype(np.float32)
    got = native.window_resize_batch(slices, 50, 200, (24, 24), n_threads=2)
    # the port's path: window, then the linear resize (same half-pixel rule)
    want = ct.resize(ct.window_ct(torch.from_numpy(slices), 50, 200), (5, 24, 24),
                     order=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_window_resize_identity_size():
    rng = np.random.default_rng(3)
    slices = rng.uniform(-50, 250, size=(3, 16, 16)).astype(np.float32)
    got = native.window_resize_batch(slices, 50, 200, (16, 16))
    want = np.clip((slices - (50 - 100)) / 200.0, 0, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_load_nifti_batch_threaded(tmp_path):
    rng = np.random.default_rng(5)
    vols, paths = [], []
    for i in range(5):
        vol = rng.uniform(-100, 200, size=(16, 16, 6 + i)).astype(np.float32)
        fn = str(tmp_path / f"v{i}.nii.gz")
        nifti.save(fn, vol, np.diag([1.0, 1.0, 2.5, 1.0]))
        vols.append(vol)
        paths.append(fn)
    out = native.load_nifti_batch(paths, n_threads=4)
    assert len(out) == 5
    for (got, pixdim), want in zip(out, vols):
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(pixdim, [1.0, 1.0, 2.5], atol=1e-5)


def test_load_nifti_batch_reports_bad_file(tmp_path):
    vol = np.ones((4, 4, 2), np.float32)
    good = str(tmp_path / "good.nii")
    nifti.save(good, vol)
    bad = str(tmp_path / "bad.nii")
    with open(bad, "wb") as f:
        f.write(b"not a nifti")
    with pytest.raises(IOError):
        native.load_nifti_batch([good, bad])


def test_decodes_as_the_jax_native_loader(tmp_path):
    _load_jax_native()
    rng = np.random.default_rng(6)
    vol = rng.uniform(-100, 200, size=(12, 10, 5)).astype(np.float32)
    fn = str(tmp_path / "v.nii.gz")
    nifti.save(fn, vol, np.diag([0.7, 0.7, 3.0, 1.0]))
    got, pixdim = native.load_nifti_f32(fn)
    want, want_pixdim = jax_native.load_nifti_f32(fn)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pixdim, want_pixdim)
    slices = np.moveaxis(vol, 2, 0)
    np.testing.assert_array_equal(native.window_resize_batch(slices, 40, 80, (7, 9)),
                                  jax_native.window_resize_batch(slices, 40, 80, (7, 9)))


def test_library_is_built_into_the_build_dir():
    path = native.build()
    assert path.parent == BUILD_DIR and path.name.startswith("libfastload_")
    assert path.parent.parts[-2:] == ("build", "ich_tpu_torch")


def test_unavailable_library_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no g++")
    assert not native.available()
    for call in (lambda: native.load_nifti_f32("x.nii"),
                 lambda: native.load_nifti_batch(["x.nii"]),
                 lambda: native.window_resize_batch(np.zeros((1, 4, 4), np.float32), 0, 1, (2, 2))):
        with pytest.raises(RuntimeError, match="unavailable: no g\\+\\+"):
            call()


def test_jax_loader_recovers_from_a_lost_build_race(monkeypatch):
    """A process that loaded the JAX library while another was writing it
    holds the failed mark and no library; the load above clears it."""
    _load_jax_native()
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_build_failed", True)
    assert not jax_native.available()
    assert _load_jax_native().available()


def test_jax_loader_raises_where_the_library_cannot_be_built(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_build_failed", True)
    monkeypatch.setattr(jax_native, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(jax_native, "_LIB", str(tmp_path / "libfastload.so"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        _load_jax_native(timeout=1.0)
