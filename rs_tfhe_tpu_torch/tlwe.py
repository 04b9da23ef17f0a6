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
    key_tensor,
    neg_torus,
    planar_limbs,
    resolve_device,
    threefry2x32_bits,
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


def bool_mu(msg, device) -> torch.Tensor:
    """The torus words of booleans: +1/8 for True, -1/8 for False, int32 on
    `device` (reference tlwe.rs:55-58)."""
    msg = torch.as_tensor(msg, dtype=torch.bool, device=device)
    return torch.where(msg, _MU_TRUE, _MU_FALSE).to(TORUS_DTYPE)


def lwe_encrypt_bool(
    generator: torch.Generator, s: torch.Tensor, msg, alpha: float
) -> torch.Tensor:
    """Boolean +/- 1/8 encoding (reference tlwe.rs:55-58)."""
    return lwe_encrypt_torus(generator, s, bool_mu(msg, s.device), alpha)


def lwe_encrypt_torus_seeded(
    generator: torch.Generator, mask_key, s: torch.Tensor, mu: torch.Tensor, alpha: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (compressed) LWE encryption: one word a ciphertext on the wire
    (rs_tfhe_tpu/tlwe.py:45-74).

    Mask row r is the threefry stream of `mask_key` over the counters
    [r*n, (r+1)*n) (`torus.threefry2x32_bits`), so only (seed, bodies)
    travel and any runtime (`lwe_expand_seeded` here or in the JAX package,
    the native client's `lwe_expand_seeded`) rebuilds the masks bit for bit.
    The noise comes from `generator` (a `torch.Generator` or
    `torus.OsRandom`), never from the seed, which is public. Use a mask key
    for ONE batch only, like any nonce.

    mask_key: two words (`torus.key_data`, `torus.split`, `torus.random_key`);
    mu: int32 [B]. Returns (seed int32 [2] on the host, bodies int32 [B] on
    s's device).
    """
    n = s.shape[0]
    (batch,) = mu.shape
    seed = key_tensor(mask_key)
    a = threefry2x32_bits(seed, 0, batch * n, s.device).reshape(batch, n)
    noise = gaussian_torus(generator, alpha, mu.shape, device=s.device)
    return seed, mu + noise + _dot_key(a, s)


def lwe_expand_seeded(seed, bodies: torch.Tensor, n: int) -> torch.Tensor:
    """(seed [2], bodies int32 [B]) -> the full LWE batch int32 [B, n+1] on
    the bodies' device."""
    (batch,) = bodies.shape
    a = threefry2x32_bits(seed, 0, batch * n, bodies.device).reshape(batch, n)
    return torch.cat([a, bodies.unsqueeze(-1)], dim=-1)


def lwe_encrypt_bool_seeded(
    generator: torch.Generator, mask_key, s: torch.Tensor, msg, alpha: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded variant of `lwe_encrypt_bool` (+/- 1/8 encoding)."""
    return lwe_encrypt_torus_seeded(generator, mask_key, s, bool_mu(msg, s.device), alpha)


def _rows_from_masks(a: torch.Tensor, body: torch.Tensor, zero_mask) -> torch.Tensor:
    """Rows [R, n+1] of masks and bodies as a planar limb table, the rows
    where `zero_mask` is set zeroed."""
    rows = torch.cat([a, body.unsqueeze(-1)], dim=-1)
    if zero_mask is not None:
        rows[torch.as_tensor(zero_mask, device=rows.device)] = 0
    return planar_limbs(rows)


def lwe_encrypt_rows_limbs(
    generator: torch.Generator, mask_key, s: torch.Tensor, mu: torch.Tensor,
    alpha: float, zero_mask=None,
) -> torch.Tensor:
    """Encrypt a 1-D batch of torus messages into a planar limb table
    (rs_tfhe_tpu/tlwe.py:87-158), in the port's layout.

    Returns int8 [R, 4*W], W = n+1 rounded up to 8 (`torus.planar_limbs`,
    `key.ksk_width`): column q*W + c holds limb q of coefficient c (masks at
    c < n, the body at c = n, zeros above). Row r's mask is the threefry
    stream of `mask_key` over the counters [r*n, (r+1)*n), as in the JAX
    package, whose mask key is the first split of the key it is called with;
    the noise comes from `generator`. Rows where `zero_mask` (bool [R]) is
    set are zero. Serves the key-switching key (key.gen_key_switching_key)
    and proxy re-keys (proxy_reenc.new_symmetric).
    """
    n = s.shape[0]
    (rows,) = mu.shape
    a = threefry2x32_bits(mask_key, 0, rows * n, s.device).reshape(rows, n)
    noise = gaussian_torus(generator, alpha, (rows,), device=s.device)
    return _rows_from_masks(a, mu + noise + _dot_key(a, s), zero_mask)


def lwe_rows_limbs_from_bodies(mask_key, bodies: torch.Tensor, n: int, zero_mask=None) -> torch.Tensor:
    """Rebuild an `lwe_encrypt_rows_limbs` table from its mask key and bodies
    (rs_tfhe_tpu/tlwe.py:161-195), in the port's layout, on the bodies'
    device: the masks are the key's public stream, the bodies hold
    mu + noise + <a, s> already, so no secret is needed."""
    (rows,) = bodies.shape
    a = threefry2x32_bits(mask_key, 0, rows * n, bodies.device).reshape(rows, n)
    return _rows_from_masks(a, bodies, zero_mask)


def lwe_phase(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """b - <a, s> (mod 2^32), int32 [...]."""
    return ct[..., -1] - _dot_key(ct[..., :-1], s)


def lwe_decrypt_bool(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Sign test on the phase (reference tlwe.rs:60-68): the torus word read
    as a signed int32 is >= 0 for phases in [0, 1/2)."""
    return lwe_phase(ct, s) >= 0


def message_mu(msg, message_modulus: int, device) -> torch.Tensor:
    """msg mod modulus times the torus word of 1/(2*modulus), mod 2^32:
    int32 on `device`."""
    msg = torch.remainder(torch.as_tensor(msg, dtype=torch.int64, device=device), message_modulus)
    return wrap_i32(msg * int(f64_to_torus(1.0 / (2.0 * message_modulus))))


def lwe_encrypt_message(
    generator: torch.Generator, s: torch.Tensor, msg, message_modulus: int, alpha: float
) -> torch.Tensor:
    """LWE message encoding msg/(2*modulus) for programmable bootstrapping
    (reference tlwe.rs:84-98; rs_tfhe_tpu/tlwe.py:216-230)."""
    return lwe_encrypt_torus(generator, s, message_mu(msg, message_modulus, s.device), alpha)


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
    mu = message_mu(msg, message_modulus, resolve_device(device))
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
