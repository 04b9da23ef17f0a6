"""Integer <-> bit <-> ciphertext conversion helpers.

Reference: rs-tfhe bit_utils.rs, as rs_tfhe_tpu/bit_utils.py. Bit order is
LSB-first (to_bits, bit_utils.rs:74-83); `convert` folds bits back MSB-down
(bit_utils.rs:9-19). Encryption of a uint yields a batch [num_bits, n0+1]:
the batch axis is the bit axis, so whole-integer circuits (models/) run every
bit position in one bootstrap batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .tlwe import lwe_decrypt_bool, lwe_encrypt_bool


def to_bits(val: int, size: int) -> np.ndarray:
    """LSB-first bit vector (reference bit_utils.rs:74-83)."""
    return np.array([(val >> i) & 1 for i in range(size)], dtype=bool)


def from_bits(bits) -> int:
    """Bits (LSB-first) -> integer (reference `convert`, bit_utils.rs:9-19)."""
    bits = np.asarray(bits, dtype=bool)
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def encrypt_uint(
    generator: torch.Generator, sk_lv0: torch.Tensor, val: int, size: int, alpha: float
) -> torch.Tensor:
    """Encrypt `size` bits of val as a ciphertext batch int32 [size, n0+1] on
    the key's device (the AsBits trait, bit_utils.rs:25-72, batched)."""
    return lwe_encrypt_bool(generator, sk_lv0, to_bits(val, size), alpha)


def decrypt_uint(ct: torch.Tensor, sk_lv0: torch.Tensor) -> int:
    """Decrypt a bit-batch ciphertext back to an integer."""
    return from_bits(lwe_decrypt_bool(ct, sk_lv0).cpu().numpy())
