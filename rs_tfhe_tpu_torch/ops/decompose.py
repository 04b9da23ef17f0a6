"""Gadget (signed base-2^bgbit) decomposition.

Reference: rs-tfhe trgsw.rs:144-171. Batched over whole TRLWE batches
[..., 2, N]; pure int32 bit manipulation.
"""

from __future__ import annotations

import torch

from ..params import TORUS_BITS, TfheParams
from ..torus import i32


def gadget_decompose(x: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """int32 [..., 2, N] -> int32 digits [..., 2L, N].

    Digit order matches the reference's TRGSW row order: rows [0, L) are the
    a-polynomial digits, rows [L, 2L) the b-polynomial digits
    (trgsw.rs:158-168). Digits lie in [-Bg/2, Bg/2).
    """
    g = params.trgsw_lv1
    # offset balances the digits; round_bit centers the dropped-bits error
    tmp = x + i32(params.decomposition_offset + params.decomposition_round_bit)
    mask = g.bg - 1
    digits = []
    for i in range(g.l):
        shift = TORUS_BITS - (i + 1) * g.bgbit
        # logical uint32 shift: the arithmetic `>>` copies the sign bit into
        # the top `shift` bits, and `& mask` (bgbit <= 32 - shift bits) drops
        # them along with the higher digits
        digits.append(((tmp >> shift) & mask) - g.half_bg)
    d = torch.stack(digits, dim=-3)  # [..., L, 2, N]
    d = d.transpose(-3, -2)  # [..., 2, L, N]
    return d.reshape(*d.shape[:-3], 2 * g.l, d.shape[-1])
