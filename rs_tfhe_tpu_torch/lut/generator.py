"""Lookup-table generation for programmable bootstrapping.

Reference: rs-tfhe lut/generator.rs:89-194 (tfhe-go style), as
rs_tfhe_tpu/lut/generator.py: fill each message's range with the encoded
output, rotate by N/(2m), negate the wrapped tail, store in the b
polynomial. Host-side numpy (a client-side operation); the result is a
LookupTable on the CPU (LutBootstrap moves it to the key's device).
"""

from __future__ import annotations

import numpy as np

from ..params import TfheParams
from ..torus import to_torch
from .encoder import Encoder
from .lookup_table import LookupTable


def div_round(a: int, b: int) -> int:
    """Reference: generator.rs:264-266."""
    return (a + b // 2) // b


class Generator:
    def __init__(self, message_modulus: int, params: TfheParams, scale: float | None = None):
        self.encoder = Encoder(message_modulus, scale)
        self.poly_degree = params.n1
        self.lookup_table_size = params.n1  # poly_extend_factor = 1
        self._params = params

    @classmethod
    def with_scale(cls, message_modulus: int, params: TfheParams, scale: float) -> "Generator":
        return cls(message_modulus, params, scale)

    @property
    def message_modulus(self) -> int:
        return self.encoder.message_modulus

    def _build(self, values: np.ndarray) -> LookupTable:
        """Shared tail: rotate by the half-range offset, negate the wrapped
        tail, store as a trivial TRLWE (a = 0)."""
        size = self.lookup_table_size
        offset = div_round(size, 2 * self.message_modulus)
        rotated = np.roll(values, -offset)  # rotated[i] = values[(i+offset) % size]
        with np.errstate(over="ignore"):
            rotated[size - offset :] = np.uint32(0) - rotated[size - offset :]
        return LookupTable(poly=to_torch(np.stack([np.zeros(size, np.uint32), rotated])))

    def _fill(self, torus_of_message) -> np.ndarray:
        size = self.lookup_table_size
        m = self.message_modulus
        values = np.zeros(size, np.uint32)
        for x in range(m):
            start = div_round(x * size, m)
            end = div_round((x + 1) * size, m)
            values[start:end] = torus_of_message(x)
        return values

    def generate_lookup_table(self, f) -> LookupTable:
        """f: message -> message (reference generator.rs:66-73, :89-137)."""
        return self._build(self._fill(lambda x: self.encoder.encode(f(x))))

    def generate_lookup_table_full(self, f) -> LookupTable:
        """f: message -> raw torus value (reference generator.rs:146-194)."""
        return self._build(self._fill(lambda x: np.uint32(f(x))))

    def generate_lookup_table_custom(self, f, message_modulus: int, scale: float) -> LookupTable:
        """Reference: generator.rs:205-224."""
        return Generator(message_modulus, self._params, scale).generate_lookup_table(f)

    def mod_switch(self, x: int) -> int:
        """Torus (2^32) -> [0, lookup_table_size) (reference generator.rs:235-238)."""
        scaled = float(np.uint32(x)) / float(0xFFFFFFFF) * self.lookup_table_size
        return int(round(scaled)) % self.lookup_table_size
