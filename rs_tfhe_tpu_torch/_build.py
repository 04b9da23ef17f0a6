"""Build and load the package's CUDA kernels at first use.

The sources under `csrc/` are compiled with `nvcc` for Hopper (`sm_90a`) into
one shared library with a plain C interface, loaded with `ctypes`. Nothing is
built when the package is imported: `load()` builds on its first call. The
library goes to `_kernels_build/<hash>/`, keyed by a hash of the sources and
the compiler flags, so an edited source rebuilds; the directory is listed in
`.gitignore`. A missing `nvcc` or a failed compile raises — there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "blind_rotate.cu",)
_OUT_ROOT = _PKG / "_kernels_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "librs_tfhe_kernels.so"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then `nvcc` on PATH, then
    /usr/local/cuda/bin/nvcc. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), _DEFAULT_NVCC]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from source at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _OUT_ROOT / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's output (with ptxas' register and shared-memory report) is
    kept beside the library as build.log."""
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc, *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (path.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_blind_rotate.argtypes = [
        p, p, p, ctypes.c_longlong, p, p, i, i, i, i, i, ctypes.c_uint, i, p,
    ]
    lib.tfhe_blind_rotate.restype = i
    lib.tfhe_cuda_error_string.argtypes = [i]
    lib.tfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on the first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib
