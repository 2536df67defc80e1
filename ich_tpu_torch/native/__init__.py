"""The native host-side data path (C++ through ctypes), the counterpart of
``ich_tpu/native``:

- :func:`load_nifti_f32`: a zlib-aware NIfTI-1 decode straight into a
  float32 buffer (scl slope and intercept applied);
- :func:`load_nifti_batch`: many files decoded at once by a C++ thread pool;
- :func:`window_resize_batch`: multithreaded HU windowing and bilinear
  resize of a slice stack.

``fastload.cpp`` is built with ``g++ -O3 -shared -fPIC ... -lz -lpthread``
at first use, never at import, into ``build/ich_tpu_torch/`` at the
repository root, named by a hash of the source and flags, so a changed
source builds anew. :func:`available` says whether the library could be
built and loaded; every other function raises ``RuntimeError`` where it
could not. Nothing falls back to the Python decoder
(:mod:`ich_tpu_torch.data.nifti`): a caller that wants it calls it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import weakref
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ich_tpu_torch.kernels._build import compile_shared

SRC = Path(__file__).resolve().parent / "fastload.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library could not be built or loaded


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native loader")
    return gxx


def build() -> Path:
    """Compile ``fastload.cpp`` unless the library for it exists; return
    its path. Raises ``RuntimeError`` without ``g++`` or on a failed
    compile."""
    return compile_shared(_gxx, GXX_FLAGS, [SRC], "libfastload", LIBS, timeout=300)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nifti_read_alloc.restype = ctypes.c_int64
    lib.nifti_read_alloc.argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p), i32p, f32p]
    lib.fastload_free.restype = None
    lib.fastload_free.argtypes = [f32p]
    lib.nifti_read_many.restype = None
    lib.nifti_read_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(f32p), i32p, f32p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    lib.window_resize_batch.restype = None
    lib.window_resize_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None (and the
    reason in ``_error``) where that failed."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _declare(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _error = str(e)
    return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native fastload unavailable: {_error}")
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _load() is not None


def load_nifti_f32(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(volume float32, reshaped in Fortran order; pixdim[1:ndim+1]) by
    the native decoder. Raises ``RuntimeError`` where the library is
    unavailable and ``IOError`` on a file it rejects."""
    lib = _require()
    dims = np.zeros(8, np.int32)
    pixdim = np.zeros(8, np.float32)
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = lib.nifti_read_alloc(
        path.encode(), ctypes.byref(ptr),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pixdim.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n < 0:
        raise IOError(f"nifti_read_alloc failed on {path} (code {n})")
    try:
        out = np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()
    finally:
        lib.fastload_free(ptr)
    ndim = int(dims[0])
    shape = tuple(int(d) for d in dims[1:1 + ndim])
    return out.reshape(shape, order="F"), pixdim[1:1 + ndim]


def load_nifti_batch(paths, n_threads: Optional[int] = None
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Decode many NIfTI files at once (a file-level C++ thread pool: each
    gzip stream is serial, so the parallelism comes from the batch).
    Returns [(volume, pixdim), ...] in input order; raises ``IOError`` if
    any file fails."""
    lib = _require()
    n = len(paths)
    if n == 0:
        return []
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    dims = np.zeros((n, 8), np.int32)
    pixdim = np.zeros((n, 8), np.float32)
    status = np.zeros(n, np.int64)
    lib.nifti_read_many(
        c_paths, n, ptrs,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pixdim.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads,
    )
    bad = [(paths[i], int(status[i])) for i in range(n) if status[i] < 0]
    if bad:
        for i in range(n):
            if ptrs[i]:
                lib.fastload_free(ptrs[i])
        raise IOError(f"nifti_read_many failed: {bad}")
    out = []
    for i in range(n):
        # zero-copy: wrap the C buffer and free it when the array dies. The
        # finalizer is on the ndarray, not its base (a memoryview, which is
        # weakref-able only from Python 3.12); the reshape keeps it alive
        # through its .base chain, so it runs when the last view dies.
        arr = np.ctypeslib.as_array(ptrs[i], shape=(int(status[i]),))
        weakref.finalize(arr, lib.fastload_free, ptrs[i])
        ndim = int(dims[i, 0])
        shape = tuple(int(d) for d in dims[i, 1:1 + ndim])
        out.append((arr.reshape(shape, order="F"), pixdim[i, 1:1 + ndim]))
    return out


def window_resize_batch(
    slices: np.ndarray,
    center: float,
    width: float,
    out_size: Tuple[int, int],
    n_threads: Optional[int] = None,
) -> np.ndarray:
    """(N, H, W) float32 slices windowed to [0, 1] and bilinearly resized
    (half-pixel centres) to (N, oh, ow)."""
    lib = _require()
    slices = np.ascontiguousarray(slices, dtype=np.float32)
    if slices.ndim != 3:
        raise ValueError(f"need (N, H, W) slices, got shape {slices.shape}")
    n, h, w = slices.shape
    oh, ow = out_size
    out = np.empty((n, oh, ow), np.float32)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.window_resize_batch(
        slices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h, w,
        ctypes.c_float(center), ctypes.c_float(width),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), oh, ow, n_threads,
    )
    return out
