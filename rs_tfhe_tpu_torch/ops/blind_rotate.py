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

`blind_rotate` routes by `config.step_impl`, the batch and the device of
its input, as rs_tfhe_tpu/ops/blind_rotate.py:242-249 does:

  - a multi-bit key under "fused_small_mb" at any batch, or under "auto" up
    to `mb_route_batch_cap(params)` ciphertexts: the multi-bit kernel
    (ops/cuda_blind_rotate_mb.py) on CUDA, `blind_rotate_mb_plain` on the
    CPU. The two rotations compute different ciphertexts, so the cap decides
    which function a batch gets and is kept as the JAX package has it.
    Without a multi-bit key "fused_small_mb" takes the standard rotation
    below, as the JAX package's call falls through to its CMUX scan;
  - "pallas": the per-step route, one external-product kernel launch per
    step (ops/cuda_step.py) on CUDA, the plain product on the CPU; it
    ignores a multi-bit key, as the JAX package does;
  - "nussbaumer": the per-step route with the Nussbaumer transform product
    (ops/nussbaumer.py; rs_tfhe_tpu/ops/blind_rotate.py:386-427), its
    pointwise dots on the probe dot's s16 unit on CUDA, their plain version
    on the CPU; it ignores a multi-bit key and raises ValueError where the
    parameters break `nussbaumer.check_bounds`;
  - "xla": `blind_rotate_plain` on the ciphertext's device, CPU or CUDA,
    with or without a multi-bit key, as the JAX package's "xla" forces its
    dot_general path (rs_tfhe_tpu/config.py:29); "auto" never takes it;
  - otherwise, with or without a multi-bit key (which also carries the
    standard `bsk`), the whole-rotation kernel (ops/cuda_blind_rotate.py) on
    CUDA, `blind_rotate_plain` on the CPU.

Nothing falls back from a kernel to a plain version.

Each call counts its route's decision (`route_calls`, `route_ciphertexts`)
and runs inside the span `tfhe.rotate.<route>`, the exponents included:
"k4" (the multi-bit kernel), "plain_mb" (its plain version), "step"
("pallas"), "nussbaumer", "k1" (the whole-rotation kernel) and "plain"
(`blind_rotate_plain`).
"""

from __future__ import annotations

import collections
import functools

import torch

from ..config import step_impl
from ..params import TORUS_BITS, TfheParams
from ..torus import logical_rshift
from ..utils.profiling import span
from . import cuda_blind_rotate, cuda_blind_rotate_mb, cuda_step, nussbaumer
from .decompose import gadget_decompose
from .poly import monomial_rotate, polymul_small_by_torus

#: The routes of `blind_rotate`, as its counters and spans name them.
ROUTES = ("k4", "plain_mb", "step", "nussbaumer", "k1", "plain")
_SPANS = {route: f"tfhe.rotate.{route}" for route in ROUTES}

#: Calls of `blind_rotate` by route in this process, and the ciphertexts
#: they rotated.
route_calls: collections.Counter = collections.Counter()
route_ciphertexts: collections.Counter = collections.Counter()


def modswitch(x: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Round torus values to [0, 2N) (reference trgsw.rs:202-211)."""
    nbit = params.trgsw_lv1.nbit
    rnd = 1 << (TORUS_BITS - nbit - 2)
    return logical_rshift(x + rnd, TORUS_BITS - nbit - 1)


def mb_route_batch_cap(params: TfheParams) -> int:
    """Largest batch "auto" routes through the multi-bit rotation: 4 where the
    gadget has L >= 3 (the strict boolean sets, RADIX, NIBBLE, TEST_TINY),
    else 2 (FAST). The JAX package's rule (rs_tfhe_tpu/ops/blind_rotate.py:49-56),
    which it set from a crossover measured on a TPU v5e (LATENCY_SWEEP_r05.json,
    2026-08): at L=2 the multi-bit chain won only to B=2 (B=4: 5.7 ms against
    5.4 per tile), at L=3 the heavier per-step dot kept the half-length chain
    ahead to B=4 (7.9 ms against 8.5), and by B=8 the per-tile kernel won
    everywhere (FAST 5.8 against 10.6, strict 8.8 against 15.4). Those are TPU
    times, not the port's: the port keeps the cap for bit-equality with the
    JAX package, since the two rotations give different ciphertexts, not for
    speed."""
    return 4 if params.trgsw_lv1.l >= 3 else 2


def rotation_exponents(ct: torch.Tensor, params: TfheParams):
    """LWE lv0 batch int32 [B, n0+1] -> (b~ int32 [B], a~ int32 [B, n0]):
    b~ = (2N - modswitch(b)) mod 2N and a~ = modswitch(a), the monomial
    exponents of the rotation (blind_rotate.py:251-252 of the reference)."""
    n0, n1 = params.n0, params.n1
    b_til = torch.remainder(2 * n1 - modswitch(ct[:, n0], params), 2 * n1)
    a_til = modswitch(ct[:, :n0], params)
    return b_til.contiguous(), a_til.contiguous()


def _rotate_steps(b_til, a_til, testvec, bsk, params, product) -> torch.Tensor:
    """The CMUX chain with `product(digits [B, 2L, N], bsk[i])` as step i's
    external product: bsk[i] is a whole step's key [2L, 2, N] here, each
    tensor-parallel shard's rows of it in parallel/sharded.py."""
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
    if bsk_mb is not None and (
        impl == "fused_small_mb" or (impl == "auto" and ct.shape[0] <= mb_route_batch_cap(params))
    ):
        route = "k4" if on_card else "plain_mb"
    elif impl == "pallas":
        route = "step"
    elif impl == "nussbaumer":
        if not nussbaumer.check_bounds(params):
            raise ValueError("nussbaumer step: parameter bounds not satisfied")
        route = "nussbaumer"
    else:
        route = "k1" if on_card and impl != "xla" else "plain"
    route_calls[route] += 1
    route_ciphertexts[route] += ct.shape[0]
    with span(_SPANS[route]):
        b_til, a_til = rotation_exponents(ct, params)
        if route == "k4":
            return cuda_blind_rotate_mb.blind_rotate_mb_kernel(b_til, a_til, testvec, bsk_mb, params)
        if route == "plain_mb":
            return blind_rotate_mb_plain(b_til, a_til, testvec, bsk_mb, params)
        if route == "k1":
            return cuda_blind_rotate.blind_rotate_kernel(b_til, a_til, testvec, bsk, params)
        if route == "plain":
            return blind_rotate_plain(b_til, a_til, testvec, bsk, params)
        if route == "step":
            product = functools.partial(cuda_step.external_product, params=params)
        else:
            def product(digits, bsk_i):
                return nussbaumer.external_product_step(digits, nussbaumer.prepare_bsk_step(bsk_i, params), params)

        return _rotate_steps(b_til, a_til, testvec, bsk, params, product)
