"""TRGSW (GSW over the torus) ciphertexts: gadget encryption, external
product and CMUX — the building blocks of blind rotation.

A batch of TRGSW ciphertexts is int32 [..., 2L, 2, N]: 2L TRLWE rows with the
gadget Bg^-(i+1) planted on row i's a-polynomial and row (i+L)'s b-polynomial
at coefficient 0 (reference trgsw.rs:11-49). The products here are the plain
exact ones of ops/poly.py.
"""

from __future__ import annotations

import torch

from .ops.decompose import gadget_decompose
from .ops.poly import polymul_small_by_torus
from .params import TORUS_BITS, TfheParams
from .trlwe import trlwe_encrypt_torus


def trgsw_encrypt_torus(
    generator: torch.Generator, s1: torch.Tensor, p: torch.Tensor,
    alpha: float, params: TfheParams, mask_grid_bits: int = 0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Encrypt small-integer messages p (int32 [...]) as TRGSW.

    Returns int32 [..., 2L, 2, N]. Reference: trgsw.rs:29-49; the gadget
    constants are the exact powers 2^(32-(i+1)*bgbit).

    mask_grid_bits: reduced-modulus rows for the rounded BSK (see
    trlwe_encrypt_torus). The smallest gadget constant must sit on the grid
    (32 - L*bgbit >= mask_grid_bits) so planting it keeps the low bits zero.

    mask: the rows' mask words int32 [..., 2L, N] before the grid is applied
    (see trlwe_encrypt_torus); None draws them from `generator`.
    """
    g = params.trgsw_lv1
    n, l = params.n1, g.l
    if mask_grid_bits > 0 and TORUS_BITS - l * g.bgbit < mask_grid_bits:
        raise ValueError("gadget constant below the BSK grid; lower bsk_round_bits")
    zeros = torch.zeros((*p.shape, 2 * l, n), dtype=torch.int32, device=s1.device)
    ct = trlwe_encrypt_torus(generator, s1, zeros, alpha, mask_grid_bits, mask)
    for i in range(l):
        scaled = p * (1 << (TORUS_BITS - (i + 1) * g.bgbit))  # p small: no wrap
        ct[..., i, 0, 0] += scaled
        ct[..., i + l, 1, 0] += scaled
    return ct


def external_product(
    trgsw: torch.Tensor, trlwe: torch.Tensor, params: TfheParams
) -> torch.Tensor:
    """TRGSW (x) TRLWE -> TRLWE (reference trgsw.rs:77-116).

    trgsw: int32 [2L, 2, N] (shared over the batch); trlwe: int32 [..., 2, N].
    """
    digits = gadget_decompose(trlwe, params)  # [..., 2L, N]
    return polymul_small_by_torus(digits, trgsw, params.trgsw_lv1.half_bg)


def cmux(
    c0: torch.Tensor, c1: torch.Tensor, cond: torch.Tensor, params: TfheParams
) -> torch.Tensor:
    """cond == 0 -> c0, cond == 1 -> c1 (reference trgsw.rs:174-196).

    cond: TRGSW int32 [2L, 2, N]; c0/c1: TRLWE int32 [..., 2, N].
    """
    return c0 + external_product(cond, c1 - c0, params)


def batch_blind_rotate(ct, testvec, bsk, params):
    """Parity alias for the reference's batch_blind_rotate (trgsw.rs:289-305;
    rs_tfhe_tpu/trgsw.py:75-80): blind rotation is batch-first, so the batch
    API is `ops.blind_rotate.blind_rotate` itself (with the standard key)."""
    from .ops.blind_rotate import blind_rotate

    return blind_rotate(ct, testvec, bsk, params)
