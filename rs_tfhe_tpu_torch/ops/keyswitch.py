"""Digit-decomposition key switching as a one-hot int8 product.

The reference (trgsw.rs:332-360) gathers rows of a large table of LWE
ciphertexts by the base-2^basebit digits of the input mask and subtracts
them. As in the JAX package, the gather is written as a product: the one-hot
selection matrix of the digits (int8) times the table's balanced int8 limb
planes, accumulated exactly in int32 by `torch._int_mm`, then recombined mod
2^32. Exact: each column sums at most n_in*t selected limbs of |l| <= 128.

Row k = 0 of each (i, j) block is zero (key.gen_key_switching_key), so
selecting it subtracts nothing.
"""

from __future__ import annotations

import torch

from ..params import TORUS_BITS, TfheParams
from ..torus import i32, recombine_planar

#: `torch._int_mm` on the card needs more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17


def _int8_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, W] -> exact int32 [M, W]; pads M to the card's
    minimum and raises on a K or W the card's product does not take."""
    m, k = lhs.shape
    if k % 8 or rhs.shape[1] % 8:
        raise ValueError(f"int8 product needs K and W multiples of 8, got {k}, {rhs.shape[1]}")
    pad = max(0, _INT_MM_MIN_ROWS - m)
    if pad:
        lhs = torch.nn.functional.pad(lhs, (0, 0, 0, pad))
    return torch._int_mm(lhs, rhs)[:m]


def digit_select_sum(
    a: torch.Tensor, table_limbs: torch.Tensor, t: int, basebit: int, out_width: int
) -> torch.Tensor:
    """Sum of the table rows selected by the digits of `a` (exact mod 2^32).

    a:           int32 [..., n_in] mask coefficients to decompose
    table_limbs: int8 [n_in * t * 2^basebit, 4 * W] planar limbs
                 (key.ksk_limbs_from_rows; padding columns are zero)
    Returns int32 [..., out_width].
    """
    base = 1 << basebit
    lead, n_in = a.shape[:-1], a.shape[-1]
    w = table_limbs.shape[-1] // 4
    a_bar = a + i32(1 << (TORUS_BITS - (1 + basebit * t)))
    # made on the device: a host-to-device copy here would make every
    # bootstrap of a chain wait for the host
    shifts = TORUS_BITS - basebit * torch.arange(1, t + 1, dtype=torch.int32, device=a.device)
    # logical uint32 shift: `& (base - 1)` drops the sign copies, since
    # basebit <= 32 - shift_j
    digits = (a_bar.unsqueeze(-1) >> shifts) & (base - 1)  # [..., n_in, t]
    onehot = digits.unsqueeze(-1) == torch.arange(base, device=a.device, dtype=torch.int32)
    lhs = onehot.to(torch.int8).reshape(-1, n_in * t * base)
    acc = _int8_matmul(lhs, table_limbs)  # [M, 4*W] int32
    return recombine_planar(acc.reshape(*lead, 4, w))[..., :out_width]


def digit_select_subtract(
    a: torch.Tensor, body: torch.Tensor, table_limbs: torch.Tensor,
    t: int, basebit: int, out_width: int,
) -> torch.Tensor:
    """(0, ..., 0, body) - sum over the selected table rows: int32
    [..., out_width]. The core of key switching."""
    res = -digit_select_sum(a, table_limbs, t, basebit, out_width)
    res[..., out_width - 1] += body
    return res


def identity_key_switch(
    ct: torch.Tensor, ksk_limbs: torch.Tensor, params: TfheParams
) -> torch.Tensor:
    """LWE lv1 [..., N+1] -> LWE lv0 [..., n0+1] (reference trgsw.rs:332-360)."""
    g = params.trgsw_lv1
    n1 = params.n1
    return digit_select_subtract(
        ct[..., :n1], ct[..., n1], ksk_limbs, g.iks_t, g.basebit, params.n0 + 1
    )
