"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``ich_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with :mod:`ctypes`. The library goes to ``build/ich_tpu_torch/`` at
the repository root, named by a hash of the sources, so a changed source
builds anew and an unchanged one is loaded as is. The build happens at
first use, never at import. :func:`compile_shared` is the build-by-hash
step itself; the native loader's g++ build uses it too.

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
from typing import Callable, Optional, Sequence

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


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): "
                           "cannot build the ich_tpu_torch CUDA kernels")
    return nvcc


def compile_shared(compiler: Callable[[], str], flags: Sequence[str],
                   sources: Sequence[Path], prefix: str, libs: Sequence[str] = (),
                   timeout: Optional[float] = None) -> Path:
    """Compile ``sources`` into one shared library under ``BUILD_DIR``,
    named ``<prefix>_<hash>.so`` by a hash of the flags and the sources,
    unless it exists; return its path. ``compiler()`` gives the compiler's
    path and is asked only where a build is needed. The compiler's output
    is kept beside the library as ``<lib>.log``; a failed compile raises
    ``RuntimeError``."""
    h = hashlib.sha256(" ".join((*flags, *libs)).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cc, *flags, *map(str, sources), "-o", tmp, *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cc)} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build() -> Path:
    """Compile the CUDA sources unless the library for them exists; return
    its path. The compiler's register/shared-memory report (``-Xptxas -v``)
    is kept beside it as ``<lib>.log``."""
    return compile_shared(_nvcc, NVCC_FLAGS, _sources(), "libich_tpu_torch")


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        signatures = {
            "edt_max_n": [],
            "edt_envelope_rows": [ptr, ptr, i32, i32, ptr],
            "edt_mask_rows": [ptr, ptr, i32, i32, ptr],
            "edt_envelope_cols_sqrt": [ptr, i32, i32, i32, ptr],
        }
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i32
        _lib = lib
    return _lib
