"""TRLWE (ring-LWE over the torus) ciphertexts, batch-first.

A batch of TRLWE ciphertexts is int32 [..., 2, N]: index 0 on the -2 axis is
the mask polynomial a(X), index 1 the body b(X) (reference trlwe.rs:10-14).
"""

from __future__ import annotations

import torch

from .ops.poly import polymul_torus_by_binary
from .torus import gaussian_torus, uniform_torus


def trlwe_encrypt_torus(
    generator: torch.Generator, s1: torch.Tensor, mu: torch.Tensor,
    alpha: float, mask_grid_bits: int = 0,
) -> torch.Tensor:
    """Encrypt torus polynomials. s1: int32 [N] binary; mu: int32 [..., N].

    Reference: trlwe.rs:30-52 (b = mu + noise + a (*) s).

    mask_grid_bits = g > 0 produces a reduced-modulus sample (the rounded
    bootstrapping key, params.bsk_round_bits), as `rs_tfhe_tpu.trlwe` does:
    the mask is drawn uniformly from the 2^g-grid of the torus, so a (*) s
    stays on the grid exactly (binary secret), and b is rounded to the grid
    to nearest afterwards.
    """
    n = s1.shape[0]
    a = uniform_torus(generator, (*mu.shape[:-1], n), device=s1.device)
    low = (1 << mask_grid_bits) - 1
    if mask_grid_bits > 0:
        # (a >> g) << g of the uint32 reference: clearing the low g bits
        # needs no logical shift on the int32 carrier
        a = a & ~low
    noise = gaussian_torus(generator, alpha, mu.shape, device=s1.device)
    b = mu + noise + polymul_torus_by_binary(a, s1)
    if mask_grid_bits > 0:
        b = (b + (1 << (mask_grid_bits - 1))) & ~low  # round to nearest, wrapping
    return torch.stack([a, b], dim=-2)


def trlwe_phase(ct: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    """b - a (*) s (mod 2^32): int32 [..., N]."""
    return ct[..., 1, :] - polymul_torus_by_binary(ct[..., 0, :], s1)
