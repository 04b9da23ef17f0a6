"""Exact negacyclic polynomial arithmetic in Z_{2^32}[X]/(X^N + 1).

Plain PyTorch versions of the products the pipeline needs, exact mod 2^32:

  - `monomial_rotate`: X^k * t as an index computation,
    out[c] = +/- t[(c - k) mod N];
  - `polymul_small_by_torus`: small-integer polynomials (gadget digits)
    times torus polynomials, as a float64 matmul against the negacyclic
    circulant of the torus side. Every product and partial sum is an integer
    below 2^53 in magnitude (checked, see `_check_f64_exact`), so the float64
    result is the exact integer, reduced mod 2^32 afterwards. Digits wider
    than 8 bits (the Uint sets, bgbit 10-23) would pass that bound against
    whole 32-bit words, so there the torus side is split into 16-bit halves
    and the two products are recombined mod 2^32;
  - `polymul_torus_by_binary`: torus polynomials times a binary key, the
    same float64 circulant product with entries in {-1, 0, 1}.

float64 matmuls run on the CPU and on the card alike (an int32 matmul has no
CUDA path in PyTorch). The blind rotation's hot loop does not come here on
the card: it runs in the hand-written kernel (ops/cuda_blind_rotate.py).
"""

from __future__ import annotations

import torch

from ..torus import neg_torus, wrap_i32

_F64_EXACT = 1 << 53
#: `torch._int_mm` on the card needs more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def exact_dot_i8(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Exact int8 contraction: [..., K] x [K, M] -> int32 [..., M]
    (rs_tfhe_tpu/ops/poly.py:46), on the CPU and on the card alike.

    `torch._int_mm` accumulates s8 x s8 products in int32: exact while each
    output's sum of |products| stays below 2^31, which holds for any K below
    2^17 and, for the one-hot and +/-1 selections of the key switch and the
    public-key encryption, for any K below 2^24. Operands the card's product
    does not take are padded with zeros, which add nothing: the rows to 17,
    K and M to multiples of 8; shapes that already fit are not copied.
    """
    lead, k = lhs.shape[:-1], lhs.shape[-1]
    if rhs.shape[0] != k or lhs.dtype != torch.int8 or rhs.dtype != torch.int8:
        raise ValueError(f"expected int8 [..., {k}] x [{k}, M], got {lhs.dtype} {tuple(lhs.shape)} "
                         f"x {rhs.dtype} {tuple(rhs.shape)}")
    m = rhs.shape[1]
    a = lhs.reshape(-1, k)
    rows = a.shape[0]
    pad_k, pad_m = -k % _INT_MM_MULTIPLE, -m % _INT_MM_MULTIPLE
    pad_rows = max(0, _INT_MM_MIN_ROWS - rows)
    if pad_k or pad_rows:
        a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_rows))
    if pad_k or pad_m:
        rhs = torch.nn.functional.pad(rhs, (0, pad_m, 0, pad_k))
    return torch._int_mm(a, rhs)[:rows, :m].reshape(*lead, m)


def negacyclic_extend(t: torch.Tensor) -> torch.Tensor:
    """int32 [..., N] -> [..., 2N] with the negated second period."""
    return torch.cat([t, neg_torus(t)], dim=-1)


def monomial_rotate(t: torch.Tensor, k) -> torch.Tensor:
    """Multiply polynomials by X^k in Z[X]/(X^N+1).

    t: int32 [..., N]; k: integer tensor (or int) broadcastable to
    t.shape[:-1], taken mod 2N. out[..., c] = t[(c - k) mod N], negated where
    (c - k) mod 2N >= N (reference trgsw.rs:307-330, with exact negation).
    """
    n = t.shape[-1]
    k = torch.as_tensor(k, dtype=torch.int64, device=t.device)
    k = k.expand(t.shape[:-1]).unsqueeze(-1)
    col = torch.arange(n, device=t.device)
    idx = torch.remainder(col - k, 2 * n)  # [..., N] in [0, 2N)
    wrapped = idx >= n
    vals = torch.gather(t, -1, torch.where(wrapped, idx - n, idx))
    return torch.where(wrapped, neg_torus(vals), vals)


def _circulant_index(n: int, device) -> torch.Tensor:
    """idx[m, c] = (c - m) mod 2N, the negacyclic circulant's index map."""
    m = torch.arange(n, device=device)
    return torch.remainder(m[None, :] - m[:, None], 2 * n)


def circulant_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """C[..., m, c] = x[..., (c - m) mod 2N]: [..., 2N] -> [..., N, N], the
    rows of a negacyclic circulant from an extended polynomial
    (rs_tfhe_tpu/ops/poly.py:98, there built from static slices for the TPU;
    here one gather)."""
    if x.shape[-1] != 2 * n:
        raise ValueError(f"expected [..., {2 * n}], got {tuple(x.shape)}")
    return x[..., _circulant_index(n, x.device)]


def negacyclic_static_roll(t: torch.Tensor, s: int) -> torch.Tensor:
    """X^s * t for a static s (taken mod 2N): two slices and a negation, as
    rs_tfhe_tpu/ops/poly.py:227. Any integer dtype; the negation wraps."""
    n = t.shape[-1]
    s = s % (2 * n)
    neg = s >= n
    s = s % n
    rolled = torch.cat([neg_torus(t[..., n - s:]), t[..., : n - s]], dim=-1) if s else t
    return neg_torus(rolled) if neg else rolled


def _f64_exact(terms: int, max_small: int, word_bits: int) -> bool:
    """A float64 sum of `terms` products |small| <= max_small times a word of
    magnitude <= 2^word_bits is exact while terms * max_small * 2^word_bits
    < 2^53."""
    return terms * max_small * (1 << word_bits) < _F64_EXACT


def _check_f64_exact(terms: int, max_small: int, word_bits: int, what: str) -> None:
    if not _f64_exact(terms, max_small, word_bits):
        raise ValueError(
            f"{what}: {terms} terms of |d| <= {max_small} times {word_bits}-bit "
            "words can reach 2^53, beyond exact float64"
        )


def _step_circulant(t: torch.Tensor) -> torch.Tensor:
    """int32 [J, O, N] torus polys -> float64 [J*N, O*N] circulant with
    C[j*N + m, o*N + c] = ext(t[j, o])[(c - m) mod 2N] (signed word values),
    so that (d.reshape(-1, J*N) @ C)[:, o*N + c] = sum_j (d_j * t_{j,o})[c]."""
    j, o, n = t.shape
    c = circulant_rows(negacyclic_extend(t).to(torch.float64), n)  # [J, O, N(m), N(c)]
    return c.permute(0, 2, 1, 3).reshape(j * n, o * n)


def polymul_small_by_torus(
    d: torch.Tensor, t: torch.Tensor, max_small: int
) -> torch.Tensor:
    """out[..., o, :] = sum_j d[..., j, :] (*) t[j, o, :]  (negacyclic, exact).

    d: int32 [..., J, N] with |d| <= max_small; t: int32 [J, O, N] shared over
    the batch. Returns int32 [..., O, N] mod 2^32 (the external-product core,
    reference trgsw.rs:77-116).

    One product against the signed words where J*N*max_small*2^31 < 2^53
    (every set with bgbit <= 8). Otherwise t = hi * 2^16 + lo with lo the
    unsigned low half in [0, 2^16) and hi the signed high half in
    [-2^15, 2^15): two products, each bounded by J*N*max_small*2^16 (2^48 at
    SECURITY_UINT4), recombined as (hi << 16) + lo mod 2^32.
    """
    j, o, n = t.shape
    lead = d.shape[:-2]
    lhs = d.reshape(-1, j * n).to(torch.float64)

    def product(words: torch.Tensor) -> torch.Tensor:  # exact integers, int64
        return (lhs @ _step_circulant(words)).to(torch.int64)

    if _f64_exact(j * n, max_small, 31):
        out = product(t)
    else:
        _check_f64_exact(j * n, max_small, 16, "polymul_small_by_torus")
        lo, hi = t & 0xFFFF, t >> 16  # arithmetic shift: hi is signed
        out = ((product(hi) & 0xFFFF) << 16) + product(lo)
    return wrap_i32(out).reshape(*lead, o, n)


def polymul_torus_by_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product a (*) s with binary s (key polynomials).

    a: int32 [..., N], s: int32 [N] in {0, 1}. Used for TRLWE encryption and
    phase (reference trlwe.rs:45, :70). |sum| <= N * 2^31 < 2^53.
    """
    n = s.shape[-1]
    _check_f64_exact(n, 1, 31, "polymul_torus_by_binary")
    circ = circulant_rows(negacyclic_extend(s).to(torch.float64), n)  # [N(m), N(c)]
    out = a.to(torch.float64) @ circ
    return wrap_i32(out.to(torch.int64))
