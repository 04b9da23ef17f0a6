"""Build and load the package's CUDA kernels at first use.

The sources under `csrc/` are compiled with `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per unit (a source, and for `blind_rotate.cu` and
`blind_rotate_mb.cu` one unit per ring size), all started together, and
linked into one shared library with a plain C interface, loaded with `ctypes`. Nothing is built when
the package is imported: `load()` builds on its first call. The library goes
to `_kernels_build/<hash>/`, keyed by a hash of the sources, the headers (`csrc/*.cuh`)
and the compiler flags, so an edited source or header rebuilds; the directory is listed in `.gitignore`.
A missing `nvcc` or a failed compile raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .utils.profiling import counter

_PKG = Path(__file__).resolve().parent
_SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("blind_rotate.cu", "blind_rotate_mb.cu", "external_product.cu", "probes.cu", "key_switch.cu")
)
#: (source, extra flags, object name) per nvcc process. The two rotation
#: kernels have most instances: one unit each per ring size 2^6..2^12, the
#: first of each with its C interface.
_UNITS = tuple(
    (src, (f"-DTFHE_LOG_N={log_n}",) + (("-DTFHE_MAIN",) if log_n == 6 else ()), f"{src.stem}_{log_n}")
    for src in _SOURCES[:2]
    for log_n in range(6, 13)
) + tuple((src, (), src.stem) for src in _SOURCES[2:])
_HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
_OUT_ROOT = _PKG / "_kernels_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-I", str(_PKG / "csrc"),
)
_LIB_NAME = "librs_tfhe_kernels.so"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: Builds in this process that ran nvcc (a library already built for these
#: sources is loaded without one).
_builds = counter("build", ("nvcc",))


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
    for src in (*_SOURCES, *_HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(f for f in _FLAGS if f != str(_PKG / "csrc")).encode())
    h.update(repr([(flags, name) for _, flags, name in _UNITS]).encode())
    return _OUT_ROOT / h.hexdigest()[:16] / _LIB_NAME


def _run(cmds: list[list[str]], log: Path) -> None:
    """Run the commands concurrently; append their output to `log`; raise
    naming the first that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    with log.open("a") as f:
        for c, out in zip(cmds, outs):
            f.write(f"$ {' '.join(c)}\n{out}")
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n{' '.join(c)}\n{out}")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compilers' output (with ptxas' register and shared-memory report) is
    kept beside the library as build.log."""
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    _builds["nvcc"] += 1
    path.parent.mkdir(parents=True, exist_ok=True)
    log = path.parent / "build.log"
    log.write_text("")
    tag = f"{os.getpid()}.tmp"
    objs = [path.with_name(f"{name}.{tag}.o") for _, _, name in _UNITS]
    tmp = path.with_name(f"{_LIB_NAME}.{tag}")
    try:
        _run([[nvcc, *_FLAGS, *flags, "-c", "-o", str(o), str(src)]
              for (src, flags, _), o in zip(_UNITS, objs)], log)
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], log)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_blind_rotate_mb.argtypes = [
        p, p, p, ctypes.c_longlong, p, p, i, i, i, i, i, ctypes.c_uint, i, i, p,
    ]
    lib.tfhe_blind_rotate_mb.restype = i
    lib.tfhe_blind_rotate_mb_max_active_clusters.argtypes = [i, i, i]
    lib.tfhe_blind_rotate_mb_max_active_clusters.restype = i
    lib.tfhe_blind_rotate_mb_max_cluster_tile.argtypes = [i]
    lib.tfhe_blind_rotate_mb_max_cluster_tile.restype = i
    lib.tfhe_blind_rotate.argtypes = [
        p, p, p, ctypes.c_longlong, p, p, p, i, i, i, i, i, ctypes.c_uint, i, i, i, p,
    ]
    lib.tfhe_blind_rotate.restype = i
    lib.tfhe_blind_rotate_strip_bytes.argtypes = [i, i, i, i, i]
    lib.tfhe_blind_rotate_strip_bytes.restype = ctypes.c_longlong
    lib.tfhe_blind_rotate_strips.argtypes = [p, p, i, i, i, i, i, p]
    lib.tfhe_blind_rotate_strips.restype = i
    lib.tfhe_blind_rotate_max_active_clusters.argtypes = [i, i, i, i, i]
    lib.tfhe_blind_rotate_max_active_clusters.restype = i
    lib.tfhe_blind_rotate_max_cluster.argtypes = [i]
    lib.tfhe_blind_rotate_max_cluster.restype = i
    lib.tfhe_external_product.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.tfhe_external_product.restype = i
    lib.tfhe_key_switch.argtypes = [
        p, ctypes.c_longlong, p, ctypes.c_longlong, p, p, p, i, i, i, i, ctypes.c_uint, i, i, i, i, i, p,
    ]
    lib.tfhe_key_switch.restype = i
    lib.tfhe_key_switch_blocks_per_sm.argtypes = [i, i, i]
    lib.tfhe_key_switch_blocks_per_sm.restype = i
    for name in ("tfhe_blind_rotate", "tfhe_blind_rotate_mb", "tfhe_external_product"):
        getattr(lib, f"{name}_max_tile").argtypes = [i]
        getattr(lib, f"{name}_max_tile").restype = i
    ll = ctypes.c_longlong
    lib.tfhe_probe_dot_s8.argtypes = [p, p, p, p, i, i, i, p]
    lib.tfhe_probe_dot_limbs.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.tfhe_probe_roll.argtypes = [p, p, i, i, i, i, p]
    lib.tfhe_probe_bitcast_i32_to_i8.argtypes = [p, p, ll, p]
    lib.tfhe_probe_unpack_s16.argtypes = [p, p, p, ll, p]
    lib.tfhe_probe_chain_dot.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, ctypes.POINTER(i), p,
    ]
    lib.tfhe_probe_roll_add.argtypes = [p, p, i, i, i, i, p]
    for name in ("dot_s8", "dot_limbs", "roll", "bitcast_i32_to_i8", "unpack_s16", "chain_dot", "roll_add"):
        getattr(lib, f"tfhe_probe_{name}").restype = i
    lib.tfhe_cuda_error_string.argtypes = [i]
    lib.tfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on the first call in this process. The
    lock is taken only until the library is loaded: after that a call is a
    read of `_lib`."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib
