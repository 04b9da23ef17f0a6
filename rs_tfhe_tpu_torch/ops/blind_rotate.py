"""Batched blind rotation: the TFHE bootstrap hot loop.

Reference: rs-tfhe trgsw.rs:198-274, and the JAX package's XLA scan
(rs_tfhe_tpu/ops/blind_rotate.py:384-432), whose function this module
computes bit for bit:

  acc = X^{b~} * testvec
  step i:  rot   = X^{a~_i} * acc            (per-ciphertext monomial rotation)
           d     = gadget_decompose(rot - acc)   [B, 2L, N]
           acc  += d (x) BSK_i                (exact negacyclic product)

`blind_rotate` dispatches on the device of its input: a CUDA tensor goes to
the hand-written kernel (ops/cuda_blind_rotate.py), a CPU tensor to
`blind_rotate_plain`, the plain PyTorch version. Nothing falls back from one
to the other.
"""

from __future__ import annotations

import torch

from ..params import TORUS_BITS, TfheParams
from ..torus import logical_rshift
from . import cuda_blind_rotate
from .decompose import gadget_decompose
from .poly import monomial_rotate, polymul_small_by_torus


def modswitch(x: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Round torus values to [0, 2N) (reference trgsw.rs:202-211)."""
    nbit = params.trgsw_lv1.nbit
    rnd = 1 << (TORUS_BITS - nbit - 2)
    return logical_rshift(x + rnd, TORUS_BITS - nbit - 1)


def rotation_exponents(ct: torch.Tensor, params: TfheParams):
    """LWE lv0 batch int32 [B, n0+1] -> (b~ int32 [B], a~ int32 [B, n0]):
    b~ = (2N - modswitch(b)) mod 2N and a~ = modswitch(a), the monomial
    exponents of the rotation (blind_rotate.py:251-252 of the reference)."""
    n0, n1 = params.n0, params.n1
    b_til = torch.remainder(2 * n1 - modswitch(ct[:, n0], params), 2 * n1)
    a_til = modswitch(ct[:, :n0], params)
    return b_til.contiguous(), a_til.contiguous()


def blind_rotate_plain(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk: torch.Tensor, params: TfheParams,
) -> torch.Tensor:
    """The plain PyTorch blind rotation, the kernel's reference.

    Same arguments and result as `cuda_blind_rotate.blind_rotate_kernel`:
    b_til int32 [B], a_til int32 [B, n0], testvec int32 [2, N] or [B, 2, N],
    bsk int32 [n0, 2L, 2, N] -> int32 [B, 2, N]. Runs on any device; each
    step's product is a float64 matmul, exact while the bound checked in
    ops/poly.py holds (every set with bgbit <= 8 and N <= 4096) and refused
    otherwise.
    """
    batch, n1 = b_til.shape[0], params.n1
    tv = testvec.expand(batch, 2, n1)
    acc = monomial_rotate(tv, b_til.unsqueeze(-1))
    for i in range(params.n0):
        rot = monomial_rotate(acc, a_til[:, i : i + 1])
        digits = gadget_decompose(rot - acc, params)
        acc = acc + polymul_small_by_torus(digits, bsk[i], params.trgsw_lv1.half_bg)
    return acc


def blind_rotate(
    ct: torch.Tensor, testvec: torch.Tensor, bsk: torch.Tensor, params: TfheParams
) -> torch.Tensor:
    """Blind-rotate a batch of lv0 LWE ciphertexts.

    ct: int32 [B, n0+1]; testvec: int32 [2, N] (shared) or [B, 2, N]
    (per-ciphertext LUTs); bsk: int32 [n0, 2L, 2, N]. Returns the accumulator
    TRLWE batch, int32 [B, 2, N].
    """
    b_til, a_til = rotation_exponents(ct, params)
    if ct.device.type == "cuda":
        return cuda_blind_rotate.blind_rotate_kernel(b_til, a_til, testvec, bsk, params)
    if ct.device.type != "cpu":
        raise ValueError(f"blind_rotate: no implementation for device {ct.device}")
    return blind_rotate_plain(b_til, a_til, testvec, bsk, params)
