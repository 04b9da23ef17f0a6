"""Batched blind rotation: the TFHE bootstrap hot loop.

Reference: rs-tfhe trgsw.rs:198-274, and the JAX package's XLA scans
(rs_tfhe_tpu/ops/blind_rotate.py), whose functions this module computes bit
for bit. The standard (CMUX) rotation, blind_rotate.py:384-432:

  acc = X^{b~} * testvec
  step i:  rot   = X^{a~_i} * acc            (per-ciphertext monomial rotation)
           d     = gadget_decompose(rot - acc)   [B, 2L, N]
           acc  += d (x) BSK_i                (exact negacyclic product)

and the multi-bit (pair-grouped) rotation with a multi-bit key,
blind_rotate.py:169-189:

  group g: k = [0, a~_{2g}, a~_{2g+1}, (a~_{2g} + a~_{2g+1}) mod 2N]
           acc = Dec(acc) (x) sum_v X^{k_v} * G_v     (replacement form)

`blind_rotate` routes by `config.step_impl` and the device of its input:

  - a multi-bit key ("auto" or "fused_small_mb"): the multi-bit kernel
    (ops/cuda_blind_rotate_mb.py) on CUDA, `blind_rotate_mb_plain` on the
    CPU, at every batch. On an NVIDIA H100 the multi-bit kernel was the
    faster of the two rotation kernels at every batch timed (PERF.md,
    crossover table), so the port has no batch cap where the JAX package
    has `mb_route_batch_cap`;
  - "pallas": the per-step route, one external-product kernel launch per
    step (ops/cuda_step.py) on CUDA, the plain product on the CPU;
  - otherwise the whole-rotation kernel (ops/cuda_blind_rotate.py) on CUDA,
    `blind_rotate_plain` on the CPU.

Nothing falls back from a kernel to a plain version.
"""

from __future__ import annotations

import functools

import torch

from ..config import step_impl
from ..params import TORUS_BITS, TfheParams
from ..torus import logical_rshift
from . import cuda_blind_rotate, cuda_blind_rotate_mb, cuda_step
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


def _rotate_steps(b_til, a_til, testvec, bsk, params, product) -> torch.Tensor:
    """The CMUX chain with `product(digits [B, 2L, N], bsk_i [2L, 2, N])`
    as each step's external product."""
    batch, n1 = b_til.shape[0], params.n1
    acc = monomial_rotate(testvec.expand(batch, 2, n1), b_til.unsqueeze(-1))
    for i in range(params.n0):
        rot = monomial_rotate(acc, a_til[:, i : i + 1])
        acc = acc + product(gadget_decompose(rot - acc, params), bsk[i])
    return acc


def blind_rotate_plain(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk: torch.Tensor, params: TfheParams,
) -> torch.Tensor:
    """The plain PyTorch blind rotation, the whole-rotation kernel's
    reference.

    Same arguments and result as `cuda_blind_rotate.blind_rotate_kernel`:
    b_til int32 [B], a_til int32 [B, n0], testvec int32 [2, N] or [B, 2, N],
    bsk int32 [n0, 2L, 2, N] -> int32 [B, 2, N]. Runs on any device; each
    step's product is exact float64 matmuls (ops/poly.py).
    """
    half_bg = params.trgsw_lv1.half_bg
    return _rotate_steps(
        b_til, a_til, testvec, bsk, params,
        lambda d, t: polymul_small_by_torus(d, t, half_bg),
    )


def blind_rotate_mb_plain(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk_mb: torch.Tensor, params: TfheParams,
) -> torch.Tensor:
    """The plain PyTorch multi-bit rotation, the multi-bit kernel's reference.

    Same arguments and result as `cuda_blind_rotate_mb.blind_rotate_mb_kernel`
    (bsk_mb int32 [n0/2, 4, 2L, 2, N]). Computes the JAX XLA path's
    acc <- Dec(acc) (x) sum_v X^{k_v} G_v in the commuted form
    acc <- sum_v X^{k_v} (Dec(acc) (x) G_v), equal mod 2^32 (a monomial
    commutes with the product): the four products share G_v over the batch,
    so one product against all four patterns serves every ciphertext.
    """
    g = params.trgsw_lv1
    batch, n1 = b_til.shape[0], params.n1
    if params.n0 % 2:
        raise ValueError(f"multi-bit grouping needs an even n0, got {params.n0}")
    acc = monomial_rotate(testvec.expand(batch, 2, n1), b_til.unsqueeze(-1))
    a1, a2 = a_til[:, 0::2], a_til[:, 1::2]
    ks = torch.stack([torch.zeros_like(a1), a1, a2, torch.remainder(a1 + a2, 2 * n1)], dim=-1)
    for grp in range(params.n0 // 2):
        pats = bsk_mb[grp].permute(1, 0, 2, 3).reshape(2 * g.l, 8, n1)  # [2L, (v, o), N]
        prod = polymul_small_by_torus(gadget_decompose(acc, params), pats, g.half_bg)
        rot = monomial_rotate(prod.reshape(batch, 4, 2, n1), ks[:, grp, :, None])
        acc = rot[:, 0] + rot[:, 1] + rot[:, 2] + rot[:, 3]  # wraps mod 2^32
    return acc


def blind_rotate(
    ct: torch.Tensor, testvec: torch.Tensor, bsk: torch.Tensor, params: TfheParams,
    bsk_mb: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blind-rotate a batch of lv0 LWE ciphertexts.

    ct: int32 [B, n0+1]; testvec: int32 [2, N] (shared) or [B, 2, N]
    (per-ciphertext LUTs); bsk: int32 [n0, 2L, 2, N]; bsk_mb: the multi-bit
    key int32 [n0/2, 4, 2L, 2, N] or None (CloudKey.generate(multibit=True)).
    Returns the accumulator TRLWE batch, int32 [B, 2, N]. Routes as the
    module docstring says (rs_tfhe_tpu/ops/blind_rotate.py:242-249 for the
    multi-bit branch).
    """
    impl = step_impl()
    if ct.device.type not in ("cuda", "cpu"):
        raise ValueError(f"blind_rotate: no implementation for device {ct.device}")
    on_card = ct.device.type == "cuda"
    b_til, a_til = rotation_exponents(ct, params)
    if impl == "fused_small_mb" and bsk_mb is None:
        raise ValueError("step_impl='fused_small_mb' needs a multi-bit key (bsk_mb)")
    if bsk_mb is not None and impl != "pallas":
        if on_card:
            return cuda_blind_rotate_mb.blind_rotate_mb_kernel(b_til, a_til, testvec, bsk_mb, params)
        return blind_rotate_mb_plain(b_til, a_til, testvec, bsk_mb, params)
    if impl == "pallas":
        product = functools.partial(cuda_step.external_product, params=params)
        return _rotate_steps(b_til, a_til, testvec, bsk, params, product)
    if on_card:
        return cuda_blind_rotate.blind_rotate_kernel(b_til, a_til, testvec, bsk, params)
    return blind_rotate_plain(b_til, a_til, testvec, bsk, params)
