"""Nussbaumer negacyclic convolution for the external product, behind
step_impl="nussbaumer" (rs_tfhe_tpu/ops/nussbaumer.py, which this module
computes bit for bit).

Nussbaumer's algorithm maps the size-N negacyclic convolution over Z/2^32
onto 2r pointwise size-m negacyclic convolutions (N = m*r) via DFTs whose
twiddles are powers of Y, pure negacyclic shifts, exact over the integers:

  A[q*r + i] -> a_i(Y) = sum_q A[..] Y^q   in S = Z[Y]/(Y^m + 1)
  A_hat[t]   = sum_i a_i * Y^(w*i*t),  w = m/r,  t < 2r     (shift-adds)
  C_hat[t]   = sum_j A_hat[t, j] (*)_m B_hat[t, j]          (s16 dots)
  16c        = IDFT (unnormalized, wrapping int32)           (shift-adds)
  c          = fold (c_k = lin_k + Y lin_{k+r}) >> log2(2r)  (exact)

The true value 2r*c fits int32 (`check_bounds`), so wrapping int32
intermediates are harmless and the final arithmetic right shift is exact.

The shift-adds are written as batch operations: each transform is one gather
over a precomputed table of source indices and signs (built once per
(m, r, device) by applying the static shifts to the indices themselves), then
a sum over the terms, in place of the 2r*(r-1) and 2r*(2r-1) separate shifts
of the JAX package's loops. The per-point contraction [B, 2L*m] x
[2L*m, 8m] (int16 -> int32 mod 2^32) runs on a CUDA tensor on the s16 unit of
the probe dot P1 (csrc/probes.cu: byte-limb products on wgmma; one launch a
DFT point, counted in `cuda_probes.launches[DOT_NAME]`), and on a CPU tensor
as its plain version, `cuda_probes.dot_plain` (exact float64).
"""

from __future__ import annotations

import functools

import torch

from ..params import TfheParams
from ..torus import recombine_planar, split_u32_limbs, wrap_i32
from ..utils.profiling import counter
from . import cuda_probes
from .poly import circulant_rows, negacyclic_extend, negacyclic_static_roll

#: transform radix: r X-coefficients -> 2r DFT points; m = N / r.
R = 8

#: The name the pointwise dot's launches are counted under in
#: `cuda_probes.launches`.
DOT_NAME = "nussbaumer_dot"

#: The pointwise dot's launches by shape (B, K, M) in this process, beside
#: `cuda_probes.launches[DOT_NAME]`.
launched_shapes = counter("nussbaumer.shape")


def check_bounds(params: TfheParams) -> bool:
    """Exactness conditions: raw digits must fit the int16 transform
    (half_bg * r < 2^15, i.e. bgbit <= 12 with r = 8; every boolean set
    qualifies) and 2r * |conv per int8 limb| must fit int32 for the exact
    division."""
    g = params.trgsw_lv1
    if g.half_bg * R >= (1 << 15):
        return False
    bound = 2 * R * 2 * g.l * params.n1 * g.half_bg * 128
    return bound < (1 << 31) and params.n1 % R == 0 and (params.n1 // R) >= R


def _signed_table(rows: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked signed 1-based source ids -> (0-based index int64, sign int32)."""
    tab = torch.stack(rows)
    return tab.abs() - 1, torch.sign(tab).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _fwd_table(m: int, r: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Index and sign [2r, r, m] into the flattened [r*m] input of `_fwd`:
    A_hat[t][y] = sum_i sign[t, i, y] * a.flat[idx[t, i, y]]."""
    ids = torch.arange(1, r * m + 1, dtype=torch.int64).reshape(r, m)
    w = m // r
    idx, sign = _signed_table(
        [torch.stack([negacyclic_static_roll(ids[i], w * i * t) for i in range(r)]) for t in range(2 * r)])
    return idx.to(device), sign.to(device)


@functools.lru_cache(maxsize=None)
def _inv_table(m: int, r: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Index and sign [r, 4r, m] into the flattened [2r*m] input of
    `_inv_fold_div`: the unnormalized IDFT and the fold in one sum,
    16 c_k = sum_t Y^(-w k t) ch_t + Y * sum_t Y^(-w (k+r) t) ch_t."""
    ids = torch.arange(1, 2 * r * m + 1, dtype=torch.int64).reshape(2 * r, m)
    w = m // r
    rows = []
    for k in range(r):
        terms = [negacyclic_static_roll(ids[t], (-w * k * t) % (2 * m)) for t in range(2 * r)]
        terms += [negacyclic_static_roll(negacyclic_static_roll(ids[t], (-w * (k + r) * t) % (2 * m)), 1)
                  for t in range(2 * r)]
        rows.append(torch.stack(terms))
    idx, sign = _signed_table(rows)
    return idx.to(device), sign.to(device)


def _signed_sum(x: torch.Tensor, table: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """sum over the table's term axis of sign * x.flat[idx], mod 2^32:
    [..., F] -> [..., *table shape without its term axis] int32."""
    idx, sign = table
    vals = x.to(torch.int32)[..., idx] * sign  # wraps; the sum below is taken mod 2^32
    return wrap_i32(vals.sum(dim=-2, dtype=torch.int64))


def _fwd(a: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """int16 [..., r, m] -> int16 [..., 2r, m]: A_hat[t] = sum_i a_i Y^(w i t).
    Exact: |A_hat| <= r * |a| < 2^15 (`check_bounds`)."""
    flat = a.reshape(*a.shape[:-2], r * m)
    return _signed_sum(flat, _fwd_table(m, r, a.device)).to(torch.int16)


def _inv_fold_div(ch: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """int32 [..., 2r, m] -> [..., r, m]: unnormalized IDFT, fold, >> log2(2r).
    Wrapping int32 throughout; exact because |2r * result| < 2^31."""
    flat = ch.reshape(*ch.shape[:-2], 2 * r * m)
    c16 = _signed_sum(flat, _inv_table(m, r, ch.device))
    return c16 >> ((2 * r).bit_length() - 1)  # arithmetic shift


def prepare_bsk_step(bsk_i: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """One BSK step int32 [2L, 2, N] -> pointwise operand int16
    [2r, 2L*m, O*4*m]: per DFT point t, the stacked circulant-m matrices of
    the transformed int8 torus limbs."""
    g = params.trgsw_lv1
    n, r = params.n1, R
    m = n // r
    j2 = 2 * g.l
    bl = split_u32_limbs(bsk_i)  # [2L, 2, N, 4] int8
    bl = bl.reshape(j2, 2, m, r, 4).to(torch.int16)
    bl = bl.permute(0, 1, 4, 3, 2)  # [2L, 2, 4, r(i), m(Y)]
    bh = _fwd(bl, m, r)  # [2L, 2, 4, 2r, m]  |values| <= r*128
    circ = circulant_rows(negacyclic_extend(bh), m)  # [2L, 2, 4, 2r, m, m]
    # -> [2r(t), 2L(j)*m(u rows), 2(o)*4(q)*m(cols)]
    circ = circ.permute(3, 0, 4, 1, 2, 5)
    return circ.reshape(2 * r, j2 * m, 2 * 4 * m)


def pointwise_dot(lhs: torch.Tensor, bop: torch.Tensor) -> torch.Tensor:
    """Per DFT point, int16 [P, B, K] x [P, K, M] -> int32 [P, B, M] mod 2^32.

    On a CUDA tensor, one launch of P1's s16 byte-limb unit a point
    (`cuda_probes._dot`, counted under DOT_NAME and in `launched_shapes`); on
    a CPU tensor its plain version, `cuda_probes.dot_plain`. K must be a
    multiple of `cuda_probes.TENSOR_K` (2L*m always is: m = N/8 >= 8)."""
    k = lhs.shape[-1]
    if k % cuda_probes.TENSOR_K:
        raise ValueError(f"the pointwise dot takes K a multiple of {cuda_probes.TENSOR_K}, got {k}")
    lhs, bop = lhs.contiguous(), bop.contiguous()
    out = torch.stack([cuda_probes._dot(DOT_NAME, lhs[t], bop[t]) for t in range(lhs.shape[0])])
    if lhs.device.type == "cuda":
        launched_shapes[(lhs.shape[1], k, bop.shape[-1])] += lhs.shape[0]
    return out


def external_product_step(digits: torch.Tensor, bop: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """digits int32 [B, 2L, N]; bop from prepare_bsk_step.
    Returns delta int32 [B, 2, N] = sum_j digits_j (*) bsk_j, mod 2^32."""
    g = params.trgsw_lv1
    n, r = params.n1, R
    m = n // r
    j2 = 2 * g.l
    batch = digits.shape[0]

    a = digits.reshape(batch, j2, m, r).to(torch.int16)
    a = a.transpose(-1, -2)  # [B, 2L, r(i), m(Y)]
    ah = _fwd(a, m, r)  # [B, 2L, 2r, m]  |values| <= r*d_max
    lhs = ah.permute(2, 0, 1, 3).reshape(2 * r, batch, j2 * m)  # [2r, B, 2L*m]

    ch = pointwise_dot(lhs, bop)  # [2r, B, O*4*m] int32
    ch = ch.reshape(2 * r, batch, 2, 4, m).permute(1, 2, 3, 0, 4)  # [B, O, 4, 2r, m]

    c = _inv_fold_div(ch, m, r)  # [B, O, 4, r(k), m(Y)] exact conv per limb
    c = c.transpose(-1, -2).reshape(batch, 2, 4, n)  # n = q*r + k order
    return recombine_planar(c)  # sum_q c_q << 8q, wrapping
