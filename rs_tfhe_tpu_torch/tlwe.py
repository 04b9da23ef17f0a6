"""(T)LWE ciphertexts over the discretized torus, batch-first.

A batch of LWE ciphertexts is int32 [..., n+1]: the first n columns are the
mask `a`, the last column the body `b` (reference tlwe.rs:11-14). The same
functions serve lv0 (n = n0) and lv1 (n = N) by passing the matching secret
key vector. All homomorphic operators are wrapping int32 arithmetic, which is
uint32 arithmetic mod 2^32 bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .torus import (
    TORUS_DTYPE,
    f64_to_torus,
    gaussian_torus,
    i32,
    neg_torus,
    resolve_device,
    to_numpy,
    uniform_torus,
    wrap_i32,
)

_MU_TRUE = i32(int(f64_to_torus(0.125)))
_MU_FALSE = i32(int(f64_to_torus(-0.125)))


def _dot_key(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 over the last axis (s binary: |sum| < n * 2^31)."""
    return wrap_i32((a.to(torch.int64) * s.to(torch.int64)).sum(-1))


def lwe_encrypt_torus(
    generator: torch.Generator, s: torch.Tensor, mu: torch.Tensor, alpha: float
) -> torch.Tensor:
    """Encrypt torus messages under binary secret s.

    s: int32 [n] in {0,1}; mu: int32 [...]; returns int32 [..., n+1] on s's
    device. Reference: tlwe.rs:37-53 (b = mu + noise + <a, s>).
    """
    n = s.shape[0]
    a = uniform_torus(generator, (*mu.shape, n), device=s.device)
    noise = gaussian_torus(generator, alpha, mu.shape, device=s.device)
    b = mu + noise + _dot_key(a, s)
    return torch.cat([a, b.unsqueeze(-1)], dim=-1)


def lwe_encrypt_bool(
    generator: torch.Generator, s: torch.Tensor, msg, alpha: float
) -> torch.Tensor:
    """Boolean +/- 1/8 encoding (reference tlwe.rs:55-58)."""
    msg = torch.as_tensor(msg, dtype=torch.bool, device=s.device)
    mu = torch.where(msg, _MU_TRUE, _MU_FALSE).to(TORUS_DTYPE)
    return lwe_encrypt_torus(generator, s, mu, alpha)


def lwe_phase(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """b - <a, s> (mod 2^32), int32 [...]."""
    return ct[..., -1] - _dot_key(ct[..., :-1], s)


def lwe_decrypt_bool(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Sign test on the phase (reference tlwe.rs:60-68): the torus word read
    as a signed int32 is >= 0 for phases in [0, 1/2)."""
    return lwe_phase(ct, s) >= 0


def _message_mu(msg, message_modulus: int, device) -> torch.Tensor:
    """msg mod modulus times the torus word of 1/(2*modulus), mod 2^32."""
    msg = torch.remainder(torch.as_tensor(msg, dtype=torch.int64, device=device), message_modulus)
    return wrap_i32(msg * int(f64_to_torus(1.0 / (2.0 * message_modulus))))


def lwe_encrypt_message(
    generator: torch.Generator, s: torch.Tensor, msg, message_modulus: int, alpha: float
) -> torch.Tensor:
    """LWE message encoding msg/(2*modulus) for programmable bootstrapping
    (reference tlwe.rs:84-98; rs_tfhe_tpu/tlwe.py:216-230)."""
    return lwe_encrypt_torus(generator, s, _message_mu(msg, message_modulus, s.device), alpha)


def lwe_decrypt_message(ct: torch.Tensor, s: torch.Tensor, message_modulus: int) -> np.ndarray:
    """Round the phase to the nearest message (reference tlwe.rs:111-126):
    int64 numpy array, in f64 semantics as rs_tfhe_tpu/tlwe.py:233-238."""
    res_f64 = to_numpy(lwe_phase(ct, s)).astype(np.float64) / float(1 << 32)
    scale = 1.0 / (2.0 * message_modulus)
    return (res_f64 / scale + 0.5).astype(np.int64) % message_modulus


def lwe_trivial_message(msg, message_modulus: int, n: int, device=None) -> torch.Tensor:
    """Noiseless maskless ciphertexts under the msg/(2*modulus) encoding
    (lwe_encrypt_message with zero mask and zero noise), on `device` (None:
    the card, torus.resolve_device)."""
    mu = _message_mu(msg, message_modulus, resolve_device(device))
    ct = torch.zeros((*mu.shape, n + 1), dtype=TORUS_DTYPE, device=mu.device)
    ct[..., -1] = mu
    return ct


def lwe_trivial_bool(msg, n: int, device=None) -> torch.Tensor:
    """Noiseless maskless ciphertexts of boolean plaintexts: body = +/-1/8,
    mask = 0 (decrypt under any key), on `device` (None: the card,
    torus.resolve_device)."""
    msg = torch.as_tensor(msg, dtype=torch.bool, device=resolve_device(device))
    ct = torch.zeros((*msg.shape, n + 1), dtype=TORUS_DTYPE, device=msg.device)
    ct[..., -1] = torch.where(msg, _MU_TRUE, -_MU_TRUE).to(TORUS_DTYPE)
    return ct


# ---------------------------------------------------------------------------
# Homomorphic linear operators (reference tlwe.rs:129-214)
# ---------------------------------------------------------------------------

def lwe_add(x, y):
    return x + y


def lwe_sub(x, y):
    return x - y


def lwe_neg(x):
    return neg_torus(x)


def lwe_mul(x, multiplier: int):
    """Scalar multiply by a known integer, mod 2^32 (negative multipliers
    wrap)."""
    return x * i32(multiplier)


def lwe_add_mul(x, y, multiplier: int):
    """x + multiplier*y (reference AddMul, tlwe.rs:185-195)."""
    return x + y * i32(multiplier)


def lwe_sub_mul(x, y, multiplier: int):
    """x - multiplier*y (reference SubMul, tlwe.rs:204-214)."""
    return x - y * i32(multiplier)


def lwe_add_bias(ct, bias: int):
    """Add a constant torus bias to the body column (returns a new tensor)."""
    out = ct.clone()
    out[..., -1] += i32(bias)
    return out
