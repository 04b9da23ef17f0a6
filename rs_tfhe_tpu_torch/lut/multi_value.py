"""Multi-value programmable bootstrapping: one blind rotation, many LUTs.

As rs_tfhe_tpu/lut/multi_value.py. Test-vector factoring in the style of
Carpov-Izabachène-Mollimard (CT-RSA 2019): over Z[X]/(X^N + 1) the all-ones
polynomial u = 1 + X + ... + X^{N-1} satisfies (1 - X) * u = 1 - X^N = 2, so
any test vector TV whose adjacent coefficient differences share an even
divisor 2c factors EXACTLY as

    TV = (c * u) * w,      w = (1 - X) * TV / (2c)   (integer coefficients).

One blind rotation with the shared accumulator TV0 = c * u followed by a
per-function multiply of the rotated TRLWE by the small integer polynomial
w_k reproduces, bit for bit, the PLAINTEXT of a dedicated rotation with
TV_k — X^{-phase} * TV0 * w_k = X^{-phase} * TV_k — while the k rotations
collapse into one. Only the noise differs: the accumulator noise is
multiplied by ||w_k||_2 (w_k is sparse: nonzero only at the LUT's bucket
boundaries, so the norm is the RMS of the LUT's value jumps), which
utils.noise.lut_margin(mv_norm=...) accounts for.

The rotation is the standard one (`ck.bsk`) even with a multi-bit key, as in
the JAX package, so the two packages' outputs agree bit for bit; the w_k
multiplies are a handful of static negacyclic rolls and int32 multiply-adds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import bootstrap as _bootstrap  # the module: it imports this package
from ..key import CloudKey
from ..ops.blind_rotate import blind_rotate
from ..ops.extract import sample_extract
from ..ops.keyswitch import identity_key_switch
from ..torus import i32, neg_torus, to_numpy, to_torch

_TWO32 = 1 << 32


@dataclasses.dataclass(frozen=True)
class MultiValueLuts:
    """A factored family of test vectors sharing one blind rotation.

    tv0:    int32 [2, N] trivial TRLWE of the common accumulator c * u, on
            the device of the test vectors it was factored from.
    terms:  per function k, a tuple of (position, coefficient) pairs: the
            nonzero entries of w_k (coefficient reduced mod 2^32).
    norms:  ||w_k||_2, for utils.noise.lut_margin(mv_norm=...).
    """

    tv0: torch.Tensor
    terms: tuple[tuple[tuple[int, int], ...], ...]
    norms: tuple[float, ...]

    @property
    def n_luts(self) -> int:
        return len(self.terms)


def factor_test_vectors(polys) -> MultiValueLuts:
    """Factor a family of trivial test vectors through a common c * u.

    polys: sequence of int32 [2, N] trivial TRLWEs (a-row zero, as built by
    lut.Generator / CloudKey.testvec). Raises ValueError if the family's
    common difference gcd is odd (then no integer factoring through c * u
    exists: fall back to per-function bootstraps).
    """
    polys = list(polys)
    if not polys:
        raise ValueError("factor_test_vectors needs at least one test vector")
    mats = [to_numpy(p) for p in polys]
    n = mats[0].shape[-1]
    diffs = []
    g = 0
    for m in mats:
        if m.shape != (2, n):
            raise ValueError(f"test vector shape {m.shape} != (2, {n})")
        if m[0].any():
            raise ValueError("multi-value factoring needs trivial test "
                             "vectors (zero mask row)")
        tv = m[1].astype(np.int64)
        d = np.empty(n, np.int64)
        d[1:] = tv[1:] - tv[:-1]
        d[0] = tv[0] + tv[-1]  # negacyclic wrap: (1 - X) * TV coefficient 0
        d = ((d + (1 << 31)) % _TWO32) - (1 << 31)  # centered mod 2^32
        diffs.append(d)
        nz = np.abs(d[d != 0])
        g = int(np.gcd(g, int(np.gcd.reduce(nz)))) if nz.size else g
    if g == 0:
        raise ValueError("all test vectors are constant; nothing to factor")
    if g % 2:
        raise ValueError(
            f"common difference gcd {g} is odd: (1-X)*TV/2c is not integer")
    c = g // 2
    terms = []
    norms = []
    for d in diffs:
        w = d // g
        pos = np.nonzero(w)[0]
        terms.append(tuple(
            (int(p), int(w[p] % _TWO32)) for p in pos))
        norms.append(float(math.sqrt(float((w.astype(np.float64) ** 2).sum()))))
    tv0 = np.stack([np.zeros(n, np.uint32),
                    np.full(n, np.uint32(c), np.uint32)])
    return MultiValueLuts(tv0=to_torch(tv0, polys[0].device), terms=tuple(terms),
                          norms=tuple(norms))


def _mul_sparse(acc: torch.Tensor, terms) -> torch.Tensor:
    """acc * w for sparse integer w: int32 [..., 2, N] -> same shape.

    Each (pos, coeff) contributes coeff * X^pos * acc; X^pos is a static
    negacyclic roll (wrapped head negated mod 2^32) and coeff rides as the
    int32 with its bits. Exact mod 2^32.
    """
    out = None
    for pos, coeff in terms:
        if pos == 0:
            shifted = acc
        else:
            rolled = torch.roll(acc, pos, dims=-1)
            shifted = torch.cat([neg_torus(rolled[..., :pos]), rolled[..., pos:]], dim=-1)
        term = shifted * i32(coeff)
        out = term if out is None else out + term
    if out is None:  # w == 0: the zero polynomial
        out = torch.zeros_like(acc)
    return out


def multi_value_bootstrap(ct: torch.Tensor, mv: MultiValueLuts,
                          ck: CloudKey) -> torch.Tensor:
    """K LUT outputs from ONE blind rotation per input ciphertext.

    ct: int32 [..., n0+1]  ->  int32 [..., K, n0+1], where output k decodes
    exactly as `bootstrap_with_testvec(ct, polys[k], ck)` would (same
    plaintext; accumulator noise scaled by mv.norms[k]).
    """
    lead = ct.shape[:-1]
    flat = ct.reshape(-1, ct.shape[-1])
    with _bootstrap.pbs_span(flat.shape[0], per_row=False):
        acc = blind_rotate(flat, mv.tv0.to(flat.device), ck.bsk, ck.params)
        accs = torch.stack([_mul_sparse(acc, t) for t in mv.terms], dim=1)
        lv1 = sample_extract(accs)  # [B, K, N+1]
        out = identity_key_switch(lv1, ck.ksk_limbs, ck.params)
    return out.reshape(*lead, mv.n_luts, out.shape[-1])
