"""Exact negacyclic polynomial arithmetic in Z_{2^32}[X]/(X^N + 1).

Plain PyTorch versions of the products the pipeline needs, exact mod 2^32:

  - `monomial_rotate`: X^k * t as an index computation,
    out[c] = +/- t[(c - k) mod N];
  - `polymul_small_by_torus`: small-integer polynomials (gadget digits)
    times torus polynomials, as a float64 matmul against the negacyclic
    circulant of the torus side. Every product and partial sum is an integer
    below 2^53 in magnitude (checked, see `_check_f64_exact`), so the float64
    result is the exact integer, reduced mod 2^32 afterwards;
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


def _check_f64_exact(terms: int, max_small: int, what: str) -> None:
    """A float64 sum of `terms` products |small| <= max_small times a signed
    int32 word (|w| <= 2^31) is exact while terms * max_small * 2^31 < 2^53."""
    if terms * max_small * (1 << 31) >= _F64_EXACT:
        raise ValueError(
            f"{what}: {terms} terms of |d| <= {max_small} times 32-bit words "
            "can reach 2^53, beyond exact float64; this parameter set needs "
            "the CUDA kernel"
        )


def _step_circulant(t: torch.Tensor) -> torch.Tensor:
    """int32 [J, O, N] torus polys -> float64 [J*N, O*N] circulant with
    C[j*N + m, o*N + c] = ext(t[j, o])[(c - m) mod 2N] (signed word values),
    so that (d.reshape(-1, J*N) @ C)[:, o*N + c] = sum_j (d_j * t_{j,o})[c]."""
    j, o, n = t.shape
    ext = negacyclic_extend(t).to(torch.float64)  # [J, O, 2N]
    c = ext[:, :, _circulant_index(n, t.device)]  # [J, O, N(m), N(c)]
    return c.permute(0, 2, 1, 3).reshape(j * n, o * n)


def polymul_small_by_torus(
    d: torch.Tensor, t: torch.Tensor, max_small: int
) -> torch.Tensor:
    """out[..., o, :] = sum_j d[..., j, :] (*) t[j, o, :]  (negacyclic, exact).

    d: int32 [..., J, N] with |d| <= max_small; t: int32 [J, O, N] shared over
    the batch. Returns int32 [..., O, N] mod 2^32 (the external-product core,
    reference trgsw.rs:77-116).
    """
    j, o, n = t.shape
    _check_f64_exact(j * n, max_small, "polymul_small_by_torus")
    lead = d.shape[:-2]
    lhs = d.reshape(-1, j * n).to(torch.float64)
    out = lhs @ _step_circulant(t)  # [F, O*N], exact integers
    return wrap_i32(out.to(torch.int64)).reshape(*lead, o, n)


def polymul_torus_by_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product a (*) s with binary s (key polynomials).

    a: int32 [..., N], s: int32 [N] in {0, 1}. Used for TRLWE encryption and
    phase (reference trlwe.rs:45, :70). |sum| <= N * 2^31 < 2^53.
    """
    n = s.shape[-1]
    _check_f64_exact(n, 1, "polymul_torus_by_binary")
    ext = negacyclic_extend(s).to(torch.float64)
    circ = ext[_circulant_index(n, s.device)]  # [N(m), N(c)]
    out = a.to(torch.float64) @ circ
    return wrap_i32(out.to(torch.int64))
