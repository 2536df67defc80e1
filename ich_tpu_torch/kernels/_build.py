"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``ich_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with :mod:`ctypes`. The library goes to ``build/ich_tpu_torch/`` at
the repository root, named by a hash of the sources, so a changed source
builds anew and an unchanged one is loaded as is. The build happens at
first use, never at import.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ich_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): "
                           "cannot build the ich_tpu_torch CUDA kernels")
    return nvcc


def build() -> Path:
    """Compile the sources unless the library for them exists; return its
    path. The compiler's register/shared-memory report (``-Xptxas -v``) is
    kept beside it as ``<lib>.log``."""
    sources = _sources()
    out = BUILD_DIR / f"libich_tpu_torch_{_digest(sources)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.edt_minplus_pass.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.edt_minplus_pass.restype = ctypes.c_int
        lib.edt_minplus_max_n.argtypes = []
        lib.edt_minplus_max_n.restype = ctypes.c_int
        _lib = lib
    return _lib
