"""ctypes bindings for the native client runtime (csrc/tfhe_client.cpp and
csrc/circuit_scheduler.cpp): the port's own copy of
rs_tfhe_tpu/native/__init__.py.

The C++ library gives exact torus and LWE client operations on the host
(numpy uint32 in and out) for a client that runs neither PyTorch nor JAX,
and the circuit planner behind `models.netlist.plan_native`. It is compiled
from the repository's sources with g++, with the JAX package's flags, at
first use (`build`), into `_build/<hash of sources and flags>/` beside this
file, which `.gitignore` lists; it never loads the JAX package's library.
A missing g++ or a failed compile raises; `available()` says whether the
library builds and loads here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRCS = tuple(_DIR.parent.parent / "csrc" / name for name in ("tfhe_client.cpp", "circuit_scheduler.cpp"))
#: rs_tfhe_tpu/native/__init__.py:27-38
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")
_LIB_NAME = "libtfhe_client.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return _DIR / "_build" / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the shared library with g++ unless it exists for these
    sources (written under a temporary name and renamed, so a concurrent
    loader sees all of it or none)."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), *map(str, _SRCS)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed with exit code {e.returncode}:\n{e.stderr}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32, u32, u64, f64 = ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_double
    signatures = {
        "negacyclic_polymul_u32": [u32p, u32p, u32p, i32],
        "negacyclic_monomial_rotate_u32": [u32p, u32p, i32, i32],
        "lwe_encrypt_batch": [u64, u32p, u32p, f64, u32p, i32, i32],
        "lwe_phase_batch": [u32p, u32p, u32p, i32, i32],
        "lwe_decrypt_bool_batch": [u32p, u32p, u8p, i32, i32],
        "gadget_decompose_batch": [u32p, i32p, i32, i32, i32, u32],
        "identity_key_switch": [u32p, u32p, u32p, i32, i32, i32, i32],
        "threefry_bits": [u32, u32, u32, u32, u32p],
        "lwe_expand_seeded": [u32, u32, u32p, u32p, i32, i32],
        "lwe_encrypt_seeded": [u32, u32, u64, u32p, u32p, f64, u32p, i32, i32, u32p],
        "lwe_encrypt_message_batch": [u64, u32p, u32p, i32, f64, u32p, i32, i32],
        "lwe_decrypt_message_batch": [u32p, u32p, i32, u32p, i32, i32],
        "trlwe_encrypt_batch": [u64, u32p, u32p, f64, u32p, i32, i32],
        "trlwe_phase_batch": [u32p, u32p, u32p, i32, i32],
        "trlwe_sample_extract": [u32p, u32p, i32, i32],
        "circuit_levelize": [i32p] * 5 + [i32] * 3 + [i32p],
        "circuit_plan": [i32p] * 5 + [i32] * 3 + [i32p] * 5 + [i32],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32 if name.startswith("circuit_") else None
    return lib


def load() -> ctypes.CDLL:
    """The library, built and bound on the first call in this process."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def available() -> bool:
    """Whether the library builds and loads on this machine."""
    try:
        load()
        return True
    except (OSError, RuntimeError, FileNotFoundError):
        return False


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def _ptr(a: np.ndarray, typ=ctypes.c_uint32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _check_len(a: np.ndarray, n: int, what: str) -> None:
    if a.shape[-1] != n:
        raise ValueError(f"{what}: expected last axis {n}, got shape {a.shape}")


def negacyclic_polymul(a, b) -> np.ndarray:
    """Exact uint32 negacyclic product of two polynomials [N]."""
    a, b = _u32(a), _u32(b)
    n = a.shape[-1]
    if a.shape != (n,) or b.shape != (n,):
        raise ValueError(f"expected two polynomials [N], got {a.shape} and {b.shape}")
    out = np.empty(n, dtype=np.uint32)
    load().negacyclic_polymul_u32(_ptr(a), _ptr(b), _ptr(out), n)
    return out


def monomial_rotate(t, k: int) -> np.ndarray:
    """X^k * t for a polynomial [N]."""
    t = _u32(t).reshape(-1)
    out = np.empty_like(t)
    load().negacyclic_monomial_rotate_u32(_ptr(t), _ptr(out), t.shape[0], int(k))
    return out


def lwe_encrypt(seed: int, s, mu, alpha: float) -> np.ndarray:
    """Encrypt a batch of torus messages; uint32 [batch, n+1]."""
    s, mu = _u32(s), np.atleast_1d(_u32(mu)).reshape(-1)
    n, batch = s.shape[0], mu.shape[0]
    out = np.empty((batch, n + 1), dtype=np.uint32)
    load().lwe_encrypt_batch(seed, _ptr(s), _ptr(mu), alpha, _ptr(out), batch, n)
    return out


def lwe_phase(ct, s) -> np.ndarray:
    ct, s = _u32(ct), _u32(s)
    ct2 = np.ascontiguousarray(np.atleast_2d(ct))
    _check_len(ct2, s.shape[0] + 1, "ct")
    out = np.empty(ct2.shape[0], dtype=np.uint32)
    load().lwe_phase_batch(_ptr(ct2), _ptr(s), _ptr(out), ct2.shape[0], s.shape[0])
    return out if ct.ndim > 1 else out[0]


def lwe_decrypt_bool(ct, s) -> np.ndarray:
    ct, s = _u32(ct), _u32(s)
    ct2 = np.ascontiguousarray(np.atleast_2d(ct))
    _check_len(ct2, s.shape[0] + 1, "ct")
    out = np.empty(ct2.shape[0], dtype=np.uint8)
    load().lwe_decrypt_bool_batch(_ptr(ct2), _ptr(s), _ptr(out, ctypes.c_uint8), ct2.shape[0], s.shape[0])
    res = out.astype(bool)
    return res if ct.ndim > 1 else res[0]


def threefry_bits(k1: int, k2: int, start: int, count: int) -> np.ndarray:
    """The JAX threefry2x32 stream (seeded-ciphertext masks), uint32 [count]."""
    if start < 0 or start + count > 1 << 32:
        raise ValueError(f"counters [{start}, {start + count}) leave the 32-bit range")
    out = np.empty(count, dtype=np.uint32)
    load().threefry_bits(k1, k2, start, count, _ptr(out))
    return out


def lwe_expand_seeded(seed, bodies, n: int) -> np.ndarray:
    """(seed uint32 [2], bodies uint32 [B]) -> the full LWE batch [B, n+1]."""
    seed, bodies = _u32(seed), np.atleast_1d(_u32(bodies)).reshape(-1)
    out = np.empty((bodies.shape[0], n + 1), dtype=np.uint32)
    load().lwe_expand_seeded(int(seed[0]), int(seed[1]), _ptr(bodies), _ptr(out), bodies.shape[0], n)
    return out


def lwe_encrypt_seeded(seed, noise_seed: int, s, mu, alpha: float) -> np.ndarray:
    """Seeded (compressed) client encryption: the masks are the threefry
    stream of the two-word `seed`, so only the bodies travel; the noise
    comes from the client's own generator seeded with `noise_seed`.
    Returns uint32 [B]."""
    seed, s, mu = _u32(seed), _u32(s), np.atleast_1d(_u32(mu)).reshape(-1)
    n, batch = s.shape[0], mu.shape[0]
    bodies = np.empty(batch, dtype=np.uint32)
    scratch = np.empty(n, dtype=np.uint32)
    load().lwe_encrypt_seeded(int(seed[0]), int(seed[1]), noise_seed, _ptr(s), _ptr(mu), alpha,
                              _ptr(bodies), batch, n, _ptr(scratch))
    return bodies


def lwe_encrypt_message(seed: int, s, msg, message_modulus: int, alpha: float) -> np.ndarray:
    """LWE messages at msg/(2*modulus) (reference tlwe.rs:84-98); uint32
    [batch, n+1]."""
    s, msg = _u32(s), np.atleast_1d(_u32(msg)).reshape(-1)
    n, batch = s.shape[0], msg.shape[0]
    out = np.empty((batch, n + 1), dtype=np.uint32)
    load().lwe_encrypt_message_batch(seed, _ptr(s), _ptr(msg), message_modulus, alpha, _ptr(out), batch, n)
    return out


def lwe_decrypt_message(ct, s, message_modulus: int) -> np.ndarray:
    """Round the phase to the nearest message (reference tlwe.rs:111-126)."""
    ct, s = _u32(ct), _u32(s)
    ct2 = np.ascontiguousarray(np.atleast_2d(ct))
    _check_len(ct2, s.shape[0] + 1, "ct")
    out = np.empty(ct2.shape[0], dtype=np.uint32)
    load().lwe_decrypt_message_batch(_ptr(ct2), _ptr(s), message_modulus, _ptr(out), ct2.shape[0], s.shape[0])
    return out if ct.ndim > 1 else out[0]


def trlwe_encrypt(seed: int, s1, mu, alpha: float) -> np.ndarray:
    """Encrypt torus polynomials mu uint32 [batch, N] (or [N]); uint32
    [batch, 2, N] (mask, body), reference trlwe.rs:30-52."""
    s1, mu = _u32(s1), _u32(mu)
    mu2 = np.ascontiguousarray(np.atleast_2d(mu))
    n, batch = s1.shape[0], mu2.shape[0]
    _check_len(mu2, n, "mu")
    out = np.empty((batch, 2, n), dtype=np.uint32)
    load().trlwe_encrypt_batch(seed, _ptr(s1), _ptr(mu2), alpha, _ptr(out), batch, n)
    return out if mu.ndim > 1 else out[0]


def trlwe_phase(ct, s1) -> np.ndarray:
    """b - a (*) s per ciphertext: uint32 [batch, N]."""
    ct, s1 = _u32(ct), _u32(s1)
    ct3 = ct.reshape(-1, 2, s1.shape[0])
    out = np.empty((ct3.shape[0], s1.shape[0]), dtype=np.uint32)
    load().trlwe_phase_batch(_ptr(ct3), _ptr(s1), _ptr(out), ct3.shape[0], s1.shape[0])
    return out.reshape(ct.shape[:-2] + (s1.shape[0],))


def trlwe_sample_extract(ct, k: int = 0) -> np.ndarray:
    """TRLWE [2, N] -> lv1 LWE [N+1] of coefficient k (exact negation;
    reference trlwe.rs:106-120)."""
    ct = _u32(ct)
    n = ct.shape[-1]
    if ct.shape != (2, n):
        raise ValueError(f"expected one TRLWE [2, N], got {ct.shape}")
    out = np.empty(n + 1, dtype=np.uint32)
    load().trlwe_sample_extract(_ptr(ct), _ptr(out), n, int(k))
    return out


def gadget_decompose(x, l: int, bgbit: int, offset: int) -> np.ndarray:
    """x: uint32 [...] -> signed digits int32 [l, ...]."""
    x = _u32(x)
    digits = np.empty((l, *x.shape), dtype=np.int32)
    load().gadget_decompose_batch(_ptr(x), _ptr(digits, ctypes.c_int32), x.size, l, bgbit,
                                  np.uint32(offset & 0xFFFFFFFF))
    return digits


def identity_key_switch(ct_lv1, ksk, n0: int, t: int, basebit: int) -> np.ndarray:
    """ct_lv1: uint32 [N+1]; ksk: uint32 [N, t, 2^basebit, n0+1]."""
    ct_lv1, ksk = _u32(ct_lv1), _u32(ksk)
    n1 = ct_lv1.shape[-1] - 1
    if ksk.shape != (n1, t, 1 << basebit, n0 + 1):
        raise ValueError(f"ksk: expected {(n1, t, 1 << basebit, n0 + 1)}, got {ksk.shape}")
    out = np.empty(n0 + 1, dtype=np.uint32)
    load().identity_key_switch(_ptr(ct_lv1), _ptr(ksk), _ptr(out), n1, n0, t, basebit)
    return out
