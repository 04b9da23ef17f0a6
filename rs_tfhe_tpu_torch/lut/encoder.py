"""Message <-> torus encoding for programmable bootstrapping.

Reference: rs-tfhe lut/encoder.rs; a copy of rs_tfhe_tpu/lut/encoder.py.
Encoding: encode(m) = m * scale with scale = 1/(2*message_modulus); decoding
rounds. Host-side (client) math in exact f64 semantics, on numpy.
"""

from __future__ import annotations

import numpy as np

from ..torus import f64_to_torus, torus_to_f64


class Encoder:
    def __init__(self, message_modulus: int, scale: float | None = None):
        self.message_modulus = message_modulus
        self.scale = 1.0 / (2.0 * message_modulus) if scale is None else scale

    @classmethod
    def with_scale(cls, message_modulus: int, scale: float) -> "Encoder":
        return cls(message_modulus, scale)

    def encode(self, message) -> np.ndarray:
        """Reference: encoder.rs:66-73."""
        message = np.asarray(message) % self.message_modulus
        return f64_to_torus(message * self.scale)

    def encode_with_scale(self, message, scale: float) -> np.ndarray:
        message = np.asarray(message) % self.message_modulus
        return f64_to_torus(message * scale)

    def decode(self, value) -> np.ndarray:
        """Reference: encoder.rs:96-105."""
        f = torus_to_f64(value)
        return (f / self.scale + 0.5).astype(np.int64) % self.message_modulus

    def decode_bool(self, value) -> np.ndarray:
        return self.decode(value) != 0
