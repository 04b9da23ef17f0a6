"""Lookup tables for programmable bootstrapping.

A LUT is a trivial TRLWE (a = 0, function values in b) used as the blind
rotation test vector. Reference: rs-tfhe lut/lookup_table.rs;
rs_tfhe_tpu/lut/lookup_table.py.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LookupTable:
    """poly: int32 [2, N] (or [B, 2, N] for per-ciphertext tables), torus
    words as the port carries them."""

    poly: torch.Tensor

    @staticmethod
    def from_poly(poly: torch.Tensor) -> "LookupTable":
        return LookupTable(poly=poly)

    @property
    def is_empty(self) -> bool:
        return not bool(self.poly.any())

    # ---- TRLWE conversions (reference: lut/lookup_table.rs:76-86) ----
    # A TRLWE ciphertext here IS an int32 [2, N] tensor (trlwe.py).

    def as_trlwe(self) -> torch.Tensor:
        """The underlying TRLWE ciphertext, int32 [..., 2, N]."""
        return self.poly

    @staticmethod
    def from_trlwe(ct: torch.Tensor) -> "LookupTable":
        """Wrap a (possibly non-trivial, i.e. encrypted) TRLWE as a LUT."""
        if ct.dtype != torch.int32:
            raise TypeError(f"expected an int32 TRLWE, got {ct.dtype}")
        if ct.dim() < 2 or ct.shape[-2] != 2:
            raise ValueError(f"expected [..., 2, N] TRLWE, got {tuple(ct.shape)}")
        return LookupTable(poly=ct)
