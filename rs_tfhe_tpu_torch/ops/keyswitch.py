"""Digit-decomposition key switching: the table rows the digits select,
summed and subtracted, by one of two routes decided by the batch.

The reference (trgsw.rs:332-360) gathers rows of a large table of LWE
ciphertexts by the base-2^basebit digits of the input mask and subtracts
them. Two routes compute that one function, bit for bit the same:

  - "product", as in the JAX package: the one-hot selection matrix of the
    digits (int8) times the table's balanced int8 limb planes, accumulated
    exactly in int32 by `torch._int_mm`, then recombined mod 2^32. Exact:
    each column sums at most n_in*t selected limbs of |l| <= 128. It reads
    the whole table whatever the batch, which pays at a large batch. The
    plain version, and the route of every CPU tensor.
  - "select": the hand-written kernel (ops/cuda_keyswitch.py,
    csrc/key_switch.cu), which reads only the selected rows, each distinct
    row once a call: the route of a batch of at most `KS_SELECT_MAX_BATCH`
    ciphertexts on the card.

Each call counts its route (`route_calls`, `route_ciphertexts`). Row k = 0
of each (i, j) block of a key-switching key is zero
(key.gen_key_switching_key); neither route relies on it.
"""

from __future__ import annotations

import collections
import math

import torch

from ..params import TORUS_BITS, TfheParams
from ..torus import i32, recombine_planar
from ..utils.profiling import span
from . import cuda_keyswitch
from .poly import exact_dot_i8

#: The largest batch that takes the selection kernel on the card: an H100
#: sweep at the SECURITY_128_BIT_FAST table (B = 1, 2, 4, ..., 512, kernel
#: against product, device ms; PERF.md) found the kernel faster at every
#: batch up to 256 (0.018 against 1.13 ms at B = 1, 1.08 against 1.41 at
#: B = 256) and slower at 512 (1.81 against 1.46): the product's time is
#: nearly flat in the batch, the kernel's grows with the rows it reads.
KS_SELECT_MAX_BATCH = 256

#: The routes, as the counters name them.
ROUTES = ("select", "product")

#: Calls by route in this process, and the ciphertexts they switched.
route_calls: collections.Counter = collections.Counter()
route_ciphertexts: collections.Counter = collections.Counter()


def ks_route(a: torch.Tensor) -> str:
    """The route of a key switch of the mask words `a` [..., n_in]."""
    if a.device.type == "cuda" and math.prod(a.shape[:-1]) <= KS_SELECT_MAX_BATCH:
        return "select"
    return "product"


def _product_sum(
    a: torch.Tensor, table_limbs: torch.Tensor, t: int, basebit: int, out_width: int
) -> torch.Tensor:
    """The product route's sum (`ops.poly.exact_dot_i8`)."""
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
    lhs = onehot.to(torch.int8).reshape(*lead, n_in * t * base)
    acc = exact_dot_i8(lhs, table_limbs)  # [..., 4*W] int32
    return recombine_planar(acc.reshape(*lead, 4, w))[..., :out_width]


def _digit_select(a, body, table_limbs, t, basebit, out_width) -> torch.Tensor:
    route = ks_route(a)
    route_calls[route] += 1
    route_ciphertexts[route] += math.prod(a.shape[:-1])
    if route == "select":
        return cuda_keyswitch.digit_select_kernel(a, body, table_limbs, t, basebit, out_width)
    res = _product_sum(a, table_limbs, t, basebit, out_width)
    if body is None:
        return res
    res = -res
    res[..., out_width - 1] += body
    return res


def digit_select_sum(
    a: torch.Tensor, table_limbs: torch.Tensor, t: int, basebit: int, out_width: int
) -> torch.Tensor:
    """Sum of the table rows selected by the digits of `a` (exact mod 2^32),
    by the batch's route (`ks_route`).

    a:           int32 [..., n_in] mask coefficients to decompose
    table_limbs: int8 [n_in * t * 2^basebit, 4 * W] planar limbs
                 (key.ksk_limbs_from_rows; padding columns are zero)
    Returns int32 [..., out_width].
    """
    return _digit_select(a, None, table_limbs, t, basebit, out_width)


def digit_select_subtract(
    a: torch.Tensor, body: torch.Tensor, table_limbs: torch.Tensor,
    t: int, basebit: int, out_width: int,
) -> torch.Tensor:
    """(0, ..., 0, body) - sum over the selected table rows: int32
    [..., out_width], by the batch's route. The core of key switching."""
    return _digit_select(a, body, table_limbs, t, basebit, out_width)


def identity_key_switch(
    ct: torch.Tensor, ksk_limbs: torch.Tensor, params: TfheParams
) -> torch.Tensor:
    """LWE lv1 [..., N+1] -> LWE lv0 [..., n0+1] (reference trgsw.rs:332-360)."""
    g = params.trgsw_lv1
    n1 = params.n1
    with span("tfhe.keyswitch"):
        return digit_select_subtract(
            ct[..., :n1], ct[..., n1], ksk_limbs, g.iks_t, g.basebit, params.n0 + 1
        )
