"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``ich_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` process a source, all started
together, and linked into one shared library with a plain C interface,
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
# IEEE float arithmetic, no --use_fast_math: the kernels round as their
# plain versions do
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
    path and is asked only where a build is needed. Each source compiles
    to an object in its own process, all at once (``flags`` less
    ``-shared``, plus ``-c``), and one more run links them. The compilers'
    output is kept beside the library as ``<lib>.log``; a failed compile
    raises ``RuntimeError``."""
    h = hashlib.sha256(" ".join((*flags, *libs)).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{i}_{p.stem}.o") for i, p in enumerate(sources)]
        obj_flags = [f for f in flags if f != "-shared"]
        log = _run_all([[cc, *obj_flags, "-c", str(p), "-o", o]
                        for p, o in zip(sources, objs)], timeout)
        tmp = Path(work) / "lib.so"
        log += _run_all([[cc, *flags, *objs, "-o", str(tmp), *libs]], timeout)
        Path(f"{out}.log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _run_all(cmds: Sequence[Sequence[str]], timeout: Optional[float]) -> str:
    """Run the commands at once; their output, or ``RuntimeError`` naming
    the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{se}")
    return "".join(so + se for so, se in outs)


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
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        u32, u64, f32 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_float
        signatures = {
            "edt_max_n": [],
            "edt_envelope_rows": [ptr, ptr, i32, i32, ptr],
            "edt_mask_rows": [ptr, ptr, i32, i32, ptr],
            "edt_envelope_cols_sqrt": [ptr, i32, i32, i32, ptr],
            "keyed_dropout": [ptr, ptr, i32, *[i64] * 6, *[u32] * 3, u64, f32, f32, ptr],
            "group_norm_relu_forward": [*[ptr] * 7, i32, *[i64] * 5, i32, i32, f32, ptr],
            "group_norm_relu_backward": [*[ptr] * 10, i32, *[i64] * 5, i32, i32, ptr],
        }
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i32
        _lib = lib
    return _lib
